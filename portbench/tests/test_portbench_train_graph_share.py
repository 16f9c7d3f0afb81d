"""The readers of ``train_graph_share.train`` and ``.train_busy``: the
replays over every sparse train step between the window's first and last
``train.step``, on planted spans and counter events; silent where no step
counted and on a device without CUDA graphs."""

import importlib.util
from types import SimpleNamespace

import pytest

import tiny

METRICS = ("train_graph_share.train", "train_graph_share.train_busy")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), tiny.BENCH / "metrics" / f"{name}.py")
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
                           window={"updates": n_window})


T0 = 1.8e15  # us on the Unix clock
# set-up's steps, a capture, a replay and a remainder's capture, then a
# window of five steps: four replays and one eager step
KINDS = ["train_graph_captures", "train_graph_replays",
         "train_graph_captures", "train_graph_replays",
         "train_graph_replays", "train_eager_steps", "train_graph_replays",
         "train_graph_replays"]
SPANS = [("train.step", "train", T0 + 10 * i, T0 + 10 * i + 8)
         for i in range(len(KINDS))]


def _plant_counts():
    from pixelpick_tpu_torch.utils import profiling

    profiling.TRACER.counts.extend(
        (name, 1, int((T0 + 10 * i + 4) * 1e3))
        for i, name in enumerate(KINDS))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n_window, share",
                         [(5, 80.0), (6, 4 / 6 * 100), (8, 62.5)])
def test_the_graph_share_counts_the_windows_train_steps(metric, n_window,
                                                        share):
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    try:
        reader = _reader(metric)
        ctx = _ctx(SPANS, n_window)
        assert reader.read(ctx) is None  # nothing counted
        _plant_counts()
        assert reader.read(ctx) == pytest.approx(share)
    finally:
        profiling.disable()
        profiling.clear()


@pytest.mark.parametrize("metric", METRICS)
def test_the_graph_share_is_silent_without_cuda_graphs(metric):
    from pixelpick_tpu_torch.utils import profiling

    profiling.clear()
    try:
        reader = _reader(metric)
        _plant_counts()
        assert reader.read(_ctx(SPANS, 5, device="cpu")) is None
        # too few train.step spans for the window
        profiling.clear()
        _plant_counts()
        assert reader.read(_ctx(SPANS[:4], 5)) is None
    finally:
        profiling.disable()
        profiling.clear()
