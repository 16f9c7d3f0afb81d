"""The port's tracer (``pixelpick_tpu_torch/utils/profiling.py``): off it
records nothing; on, spans nest, keep the main thread's CPU time and share
``torch.profiler``'s clock; the program marks its spans in a profile only
inside its own ``trace()``; and a tiny CPU round records the spans of its
epoch loop, eval step and pool sweep where they belong."""

import contextlib
import io
import json
import os
import time

import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile, record_function

from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.utils import profiling
from pixelpick_tpu_torch.utils.profiling import PhaseTimer, span, trace
from tests.helpers import make_synthetic_camvid

N_TRAIN, PIXELS = 8, 5


@pytest.fixture
def tracer():
    profiling.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


def test_off_records_nothing():
    assert not profiling.enabled()
    assert span("a") is span("b")
    assert profiling.allocator_calls(torch.device("cpu")) is span("c")
    with span("a"), span("b"):
        profiling.count("n", 3)
    with PhaseTimer().phase("train"):
        pass
    assert profiling.spans() == []
    assert profiling.counters() == {}


def test_spans_nest_with_their_parents(tracer):
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            profiling.count("n", 2)
            profiling.count("n")
    got = {r.name: r.parent for r in profiling.spans()}
    assert got == {"a": None, "b": "a", "c": "b", "d": "a"}
    assert [r.name for r in profiling.spans()] == ["c", "b", "d", "a"]
    assert profiling.counters() == {"n": 3}
    by = {r.name: r for r in profiling.spans()}
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].start_ns
    assert by["c"].end_ns <= by["b"].end_ns <= by["d"].start_ns
    assert by["d"].end_ns <= by["a"].end_ns


def test_a_sleep_shows_as_wall_without_cpu(tracer):
    with span("sleep"):
        time.sleep(0.05)
    (r,) = profiling.spans()
    wall = (r.end_ns - r.start_ns) / 1e9
    waited = wall - r.cpu_ns / 1e9
    assert 0.05 <= wall < 0.5
    assert 0.04 <= waited <= wall


def test_spans_share_the_profilers_clock(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the first range's set-up cost
            pass
        for _ in range(5):
            with record_function("probe"), span("probe"):
                time.sleep(0.001)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "probe"), key=lambda e: e.start_ns())
    records = profiling.spans()
    assert len(events) == len(records) == 5
    # the clock's offset, not a context switch between the two opens
    gaps = sorted(abs(e.start_ns() - r.start_ns)
                  for e, r in zip(events, records))
    assert gaps[2] < 2_000_000


def _names(prof) -> set:
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_spans_are_marked_only_in_the_programs_own_trace(tracer, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("train.step"):
            torch.ones(3).add_(1)
    assert "train.step" not in _names(prof)
    assert [r.name for r in profiling.spans()] == ["train.step"]

    profiling.disable()
    with trace(str(tmp_path)):
        assert profiling.enabled()
        with span("query.score"):
            torch.ones(3).add_(1)
    assert not profiling.enabled()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert "query.score" in {e.get("name") for e in events}
    assert [r.name for r in profiling.spans()][-1] == "query.score"


def test_timing_json_adds_span_totals_when_on(tracer, tmp_path):
    timer = PhaseTimer()
    with timer.phase("train", 4):
        with span("train.step"):
            time.sleep(0.002)
    timer.dump(str(tmp_path / "timing.json"))
    got = json.loads((tmp_path / "timing.json").read_text())
    assert set(got) == {"train", "spans"}
    assert got["spans"]["train"]["count"] == 1
    assert got["spans"]["train.step"]["count"] == 1
    assert got["spans"]["train.step"]["wall_s"] >= 0.002
    assert {r.parent for r in profiling.spans()} == {None, "train"}


@pytest.fixture(scope="module")
def traced_round(tmp_path_factory):
    from pixelpick_tpu_torch.cli.main_al import main

    tmp = tmp_path_factory.mktemp("traced")
    root = make_synthetic_camvid(str(tmp / "ds"), n_train=N_TRAIN, n_test=4)
    os.rename(f"{root}/test", f"{root}/val")
    os.rename(f"{root}/testannot", f"{root}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=4,
               ignore_index=11, n_classes=11, n_epochs=1,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp / "custom.yaml").write_text(yaml.safe_dump(cfg))
    ckpt = tmp / "ckpt"
    profiling.clear()
    profiling.enable()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(["-pdc", str(tmp / "custom.yaml"), "--dir_checkpoints",
                  str(ckpt), "--device", "cpu", "--width_multiplier", "0.5",
                  "--n_pixels_by_us", str(PIXELS), "--max_budget",
                  str(PIXELS), "--top_n_percent", "0", "-qs",
                  "margin_sampling", "--n_workers", "2",
                  "--pool_batch_size", "3", "--seed", "1"])
        records = profiling.spans()
    finally:
        profiling.disable()
        profiling.clear()
        layers.set_depthwise_impl("xla")
    return ckpt, records


def _inside(outer, records):
    return [r for r in records if outer.start_ns <= r.start_ns
            and r.end_ns <= outer.end_ns and r is not outer]


def test_a_round_records_one_step_and_its_children_per_update(traced_round):
    _, records = traced_round
    steps = [r for r in records if r.name == "train.step"]
    # one stage: one epoch of 8 images at batch 4
    assert len(steps) == 2
    assert {r.parent for r in steps} == {"train"}
    for name, n in (("train.upload", 2), ("train.close", 1),
                    ("train.load", 3)):  # the epoch's last wait finds none
        got = [r for r in records if r.name == name]
        assert len(got) == n and {r.parent for r in got} == {"train"}, name
    for s in steps:
        kids = [r.name for r in _inside(s, records)
                if r.parent == "train.step"]
        assert kids == ["train.forward", "train.backward", "train.optimizer"]


def test_a_round_records_the_eval_step_and_its_vis_maps(traced_round):
    _, records = traced_round
    steps = [r for r in records if r.name == "val.step"]
    # 4 validation images at batch 1; the train PNG's in the vis phase
    assert sorted(r.parent for r in steps) == ["val"] * 4 + ["vis"]
    for name, n in (("val.load", 5), ("val.upload", 4), ("val.close", 1)):
        got = [r for r in records if r.name == name]
        assert len(got) == n and {r.parent for r in got} == {"val"}, name
    for s in steps:
        kids = [r.name for r in _inside(s, records) if r.parent == "val.step"]
        assert kids == ["val.forward", "val.vis"]


def test_a_round_records_the_sweeps_bookkeeping_per_pool_batch(traced_round):
    ckpt, records = traced_round
    # one sweep of 8 pool images at batch 3: 3 batches
    for name, n in (("query.load", 4), ("query.upload", 3),
                    ("query.score", 3), ("query.readback", 3),
                    ("query.encode", 3), ("query.stats", 3),
                    ("query.close", 1)):
        got = [r for r in records if r.name == name]
        assert len(got) == n and {r.parent for r in got} == {None}, name
    timing = json.loads((ckpt / "0_query" / "timing.json").read_text())
    assert set(timing) == {"train", "vis", "val", "spans"}
    assert timing["train"]["items"] == N_TRAIN
    assert timing["spans"]["train.step"]["count"] == 2
    # dumped again after the sweep, with its spans
    assert timing["spans"]["query.score"]["count"] == 3
