"""The readers of the port's own spans (``pb/program.py``): a traced CPU
run reports the host-side ones and leaves the device-idle ones silent; an
untraced run keeps the port's tracer off; the idle arithmetic on a made-up
stretch; the span report of a traced run."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def run_then(root, code_after: str, workload: str, trace: int,
             script: str = "run"):
    """``<script>.main`` of the copy at ``root`` on the CPU, then
    ``code_after`` in the same interpreter, which prints its own line."""
    code = (f"import sys; sys.path.insert(0, 'portbench'); import {script}; "
            f"rc = {script}.main(['--workload', {workload!r}, '--seed', "
            f"'4100000123', '--seconds', '1', '--trace', '{trace}'], "
            "device='cpu'); assert rc == 0, rc\n" + code_after)
    env = dict(os.environ, PYTHONPATH=str(tiny.REPO), OMP_NUM_THREADS="4")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.strip().splitlines()
            if line.startswith("{")]


TRACER_STATE = ("import json; from pixelpick_tpu_torch.utils import "
                "profiling as p; print(json.dumps({'on': p.enabled(), "
                "'spans': len(p.spans())}))")


def test_a_traced_training_run_reports_the_step_waits(root):
    res, state = run_then(root, TRACER_STATE, "r50fpn_voc.train", trace=1)
    assert res["correct"] is True, res["checks"]
    # no device on the CPU: the idle and allocator readers stay silent
    assert set(res["metrics"]) == {"loader_wait_ms.train",
                                   "step_host_ms.train",
                                   "step_blocked_ms.train"}
    assert res["metrics"]["step_blocked_ms.train"]["value"] >= 0.0
    assert state["on"] is True and state["spans"] > 0


def test_an_untraced_run_keeps_the_tracer_off(root):
    res, state = run_then(root, TRACER_STATE, "mv2dl_camvid.val", trace=0)
    assert res["correct"] is True
    assert state == {"on": False, "spans": 0}


def test_a_traced_validation_run_reports_the_vis_maps_host_time(root):
    res, = run_then(root, "", "mv2dl_camvid.val", trace=1)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"eval_host_ms.val", "vis_host_ms.val"}
    vis = res["metrics"]["vis_host_ms.val"]["value"]
    assert 0.0 < vis < res["metrics"]["eval_host_ms.val"]["value"]


def test_the_span_report_names_the_windows_spans(root):
    res, report = run_then(root, "", "mv2dl_camvid.sweep", trace=1,
                           script="span_report")
    assert res["correct"] is True
    win = report["spans"]["window"]
    assert win["unit"] == "query.score" and win["units"] >= 1
    assert win["by_span"]["query.score"]["count"] == win["units"]
    # the window runs from the first score's start to the last one's end:
    # the first batch's upload and the last one's bookkeeping fall outside
    for name in ("query.readback", "query.encode", "query.stats",
                 "query.upload"):
        assert win["by_span"][name]["count"] == win["units"] - 1, name
    assert report["spans"]["stretch"] == {}  # no device operations


def _ctx(ops, spans, units=2):
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    profiling.TRACER.records.extend(
        profiling.SpanRecord(name, parent, int(s * 1e3), int(e * 1e3), 0)
        for name, parent, s, e in spans)
    stretch = SimpleNamespace(ops=sorted(ops), marks=[],
                              work={"from": 5, "to": 5 + units})
    return SimpleNamespace(stretch=stretch)


def test_idle_is_laid_over_the_spans_on_one_clock():
    from pb import program
    from pixelpick_tpu_torch.utils import profiling

    t0 = 1.8e15  # us on the Unix clock, as the profiler stamps them
    ops = [(t0 + a, t0 + b, "k") for a, b in
           [(0, 10), (5, 20), (30, 40), (70, 100)]]
    spans = [("train.step", "train", t0 - 5, t0 + 50),
             ("train.forward", "train.step", t0 - 4, t0 + 25),
             ("train.backward", "train.step", t0 + 25, t0 + 45),
             ("query.encode", None, t0 + 60, t0 + 80)]
    try:
        ctx = _ctx(ops, spans)
        # idle: [20, 30) and [40, 70) us; [20, 25) in the forward,
        # [25, 30) and [40, 45) in the backward, [45, 50) in the step's own
        # time, [50, 60) in no span, [60, 70) in the encoding
        assert program.idle_inside_ms(ctx, {"train.step"}) == \
            pytest.approx((10 + 10) / 1e3)
        assert program.idle_inside_ms(ctx, {"query.encode"}) == \
            pytest.approx(10 / 1e3)
        assert program.idle_inside_ms(ctx, {"query.stats"}) is None
        by = program.idle_by_span(ctx)
        assert by == pytest.approx({"train.forward": 5e-3,
                                    "train.backward": 10e-3,
                                    "train.step": 5e-3, None: 10e-3,
                                    "query.encode": 10e-3})
        assert program.idle_inside_ms(_ctx([], spans), {"train.step"}) \
            is None
    finally:
        profiling.clear()
