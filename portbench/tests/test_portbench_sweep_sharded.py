"""The ``sweep_sharded`` phase (``phases/sweep_sharded.py``, ``pb/ranks.py``)
on the CPU, in a copy cut to CPU size with two gloo ranks: a traced and an
untraced run are correct and read what the CPU can; the planted ``altered``
fault is refused; a rank killed or stuck mid-window ends the run non-zero,
with no result line, well inside two minutes; and the new readers are
silent where the port has no rank-tagged records and no collective
counters (the parent commit's port), and read the skew of made-up
records."""

import json
import time
from types import SimpleNamespace

import pytest

import tiny

WORKLOAD = "mv2dl_large.sweep_h4"
LIMIT_S = 120  # a failed rank ends the run within this
NEW_READERS = ("collective_ms.sweep_h4", "collective_mib.sweep_h4",
               "rank_skew_ms.sweep_h4", "device_idle_share.sweep_h4",
               "mfu.sweep_h4")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make(tmp_path_factory.mktemp("tiny"))
    path = root / "portbench" / "traffic" / "sweep_h4.json"
    traffic = json.loads(path.read_text())
    traffic["ranks"] = 2
    path.write_text(json.dumps(traffic))
    return root


def test_a_traced_run_over_two_ranks_is_correct(root):
    res = tiny.result(tiny.run(root, WORKLOAD, trace=1))
    assert res["correct"] is True, res["checks"]
    # no device on the CPU: the NCCL time, idle share and mfu stay silent
    assert set(res["metrics"]) == {"collective_mib.sweep_h4",
                                   "rank_skew_ms.sweep_h4"}
    assert res["metrics"]["collective_mib.sweep_h4"]["value"] > 0
    assert res["metrics"]["rank_skew_ms.sweep_h4"]["value"] >= 0


def test_an_untraced_run_reports_the_rate(root):
    res = tiny.result(tiny.run(root, WORKLOAD, trace=0))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"sweep_images_per_s", "setup_s"}
    assert res["attempted"] % 14 == 0  # whole sweeps of the 14-image pool


def test_the_altered_fault_is_refused(root):
    res = tiny.result(tiny.run(root, WORKLOAD, fault="altered"))
    assert res["correct"] is False


@pytest.mark.parametrize("fault", ["rank_lost", "rank_hung"])
def test_a_rank_lost_or_stuck_mid_window_ends_the_run(root, fault):
    t0 = time.monotonic()
    proc = tiny.run(root, WORKLOAD, fault=fault, seconds=30.0,
                    timeout=LIMIT_S + 60)
    assert time.monotonic() - t0 < LIMIT_S, proc.stderr[-2000:]
    assert proc.returncode != 0
    assert not any(line.startswith("{")
                   for line in proc.stdout.splitlines())


def _span(name, start_ns, **kw):
    from pixelpick_tpu_torch.utils import profiling

    return profiling.SpanRecord(name, None, start_ns, start_ns + 1000, 0,
                                **kw)


def _ctx(records, gathered=None, stretch=None):
    from pb import counts
    from pb.cell import Cell
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    profiling.TRACER.records.extend(records)
    cell = Cell(WORKLOAD)
    return cell, SimpleNamespace(
        cell=cell, cfg=cell.config, phase=SimpleNamespace(
            rank_records=gathered), window={"batches": 2, "images": 8,
                                            "seconds": 1.0},
        stretch=stretch, peaks=None, counts=counts)


def test_the_new_readers_are_silent_without_the_ports_rank_tracing():
    from pixelpick_tpu_torch.utils import profiling

    # the parent's port: query.score spans without a gather or a counter
    stretch = SimpleNamespace(ops=[(0.0, 5.0, "gemm")], marks=[],
                              work={"from": 0, "to": 1}, seconds=1e-5,
                              busy_us=lambda: 5.0,
                              device_ms_of=lambda names: 0.0)
    try:
        for st in (None, stretch):
            cell, ctx = _ctx([_span("query.score", t) for t in (10, 20)],
                             stretch=st)
            got = {n: cell.metric_module(n).read(ctx) for n in NEW_READERS}
            silent = set(NEW_READERS) - {"device_idle_share.sweep_h4"} \
                if st is not None else set(NEW_READERS)
            assert {n for n, v in got.items() if v is None} == silent, got
    finally:
        profiling.clear()


def test_the_skew_is_the_latest_ranks_start_less_the_earliest():
    from pixelpick_tpu_torch.utils import profiling

    # rank 0's window is its last two batches; rank 1 starts 3 and 1 us
    # later, rank 2 2 us earlier then 4 later
    own = [_span("query.score", t, rank=0) for t in (0, 10_000, 20_000)]
    gathered = [(own, []),
                ([_span("query.score", t, rank=1)
                  for t in (50, 13_000, 21_000)], []),
                ([_span("query.score", t, rank=2)
                  for t in (0, 8_000, 24_000)], [])]
    try:
        cell, ctx = _ctx(own, gathered)
        skew = cell.metric_module("rank_skew_ms.sweep_h4").read(ctx)
        assert skew == pytest.approx(((13_000 - 8_000) + (24_000 - 20_000))
                                     / 2 / 1e6)
        gathered[2][0].pop()  # a rank whose batches do not line up
        assert cell.metric_module("rank_skew_ms.sweep_h4").read(ctx) is None
    finally:
        profiling.clear()
