"""The reader of ``eval_graph_share.val``: the replays over every eval step
between the window's first and last ``val.step``, on planted spans and
counter events; silent where no step counted and on a device without CUDA
graphs."""

import importlib.util
from types import SimpleNamespace

import pytest

import tiny


def _reader():
    spec = importlib.util.spec_from_file_location(
        "eval_graph_share_val", tiny.BENCH / "metrics"
        / "eval_graph_share.val.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)  # turns the tracer on
    return reader


def _ctx(spans, n_window, device="cuda"):
    import torch

    from pixelpick_tpu_torch.utils import profiling

    profiling.TRACER.records.extend(
        profiling.SpanRecord(name, parent, int(s * 1e3), int(e * 1e3), 0)
        for name, parent, s, e in spans)
    return SimpleNamespace(stretch=None,
                           phase=SimpleNamespace(device=torch.device(device)),
                           window={"image_ms": [1.0] * n_window})


T0 = 1.8e15  # us on the Unix clock
# two steps before the window, an eager one and a capture, then a window
# of four steps: three replays and one eager step
KINDS = ["eval_eager_steps", "eval_graph_captures", "eval_graph_replays",
         "eval_graph_replays", "eval_eager_steps", "eval_graph_replays"]
SPANS = [("val.step", "val", T0 + 10 * i, T0 + 10 * i + 8)
         for i in range(len(KINDS))]


def _plant_counts():
    from pixelpick_tpu_torch.utils import profiling

    profiling.TRACER.counts.extend(
        (name, 1, int((T0 + 10 * i + 4) * 1e3))
        for i, name in enumerate(KINDS))


@pytest.mark.parametrize("n_window, share", [(4, 75.0), (6, 50.0)])
def test_the_graph_share_counts_the_windows_eval_steps(n_window, share):
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    try:
        reader = _reader()
        ctx = _ctx(SPANS, n_window)
        assert reader.read(ctx) is None  # nothing counted
        _plant_counts()
        assert reader.read(ctx) == pytest.approx(share)
    finally:
        profiling.disable()
        profiling.clear()


def test_the_graph_share_is_silent_without_cuda_graphs():
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    try:
        reader = _reader()
        _plant_counts()
        assert reader.read(_ctx(SPANS, 4, device="cpu")) is None
        # too few val.step spans for the window
        profiling.clear()
        _plant_counts()
        assert reader.read(_ctx(SPANS[:3], 4)) is None
    finally:
        profiling.disable()
        profiling.clear()
