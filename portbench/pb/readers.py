"""What the metric readers under ``portbench/metrics/`` share. Each reader
is ``read(ctx) -> float | None``; ``ctx`` holds the cell, its
configuration, the window's counts, the host spans over the window
(``spans``: name -> seconds of each), the parsed profiled stretch (or None),
the card's peaks (or None), ``setup_s`` and ``pb/counts.py``. A reader that
finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Optional

import numpy as np


def rate(ctx, key: str = "images") -> float:
    """Work of the whole window over its seconds."""
    return ctx.window[key] / ctx.window["seconds"]


def mean_ms(ctx, span: str) -> Optional[float]:
    """The mean of a host span over the window, in ms."""
    s = ctx.spans.get(span)
    return 1e3 * sum(s) / len(s) if s else None


def mfu(ctx, flops_per_image: float) -> Optional[float]:
    """Per cent of the card's f32 peak (TF32 off: the rate outside the
    tensor cores) that the model's operations reach over the window."""
    if ctx.peaks is None or not ctx.window["images"]:
        return None
    return 100.0 * flops_per_image * rate(ctx) / ctx.peaks["f32_flops"]


def stretch_images(ctx) -> int:
    """The images of the training updates of the profiled stretch."""
    w = ctx.stretch.work
    return sum(ctx.phase.batch_rows[w["from"]:w["to"]])


def busy_s_per_image(ctx) -> Optional[float]:
    """The device's busy seconds (the union of its operations' intervals)
    over the profiled stretch, per image of the stretch's updates."""
    st = ctx.stretch
    if st is None or not st.ops:
        return None
    images = stretch_images(ctx)
    return st.busy_us() / 1e6 / images if images else None


def idle_share(ctx) -> Optional[float]:
    """Per cent of the profiled stretch in which the device ran nothing."""
    st = ctx.stretch
    if st is None or not st.ops:
        return None
    return 100.0 * (1.0 - st.busy_us() / 1e6 / st.seconds)


def launched(ctx, counter: str) -> Optional[int]:
    """Launches of a port kernel counter over the stretch."""
    w = ctx.stretch.work
    if "launches_to" not in w:
        return None
    return w["launches_to"].get(counter, 0) - w["launches_from"].get(
        counter, 0)


def roofline(ctx, metric: str, least_s: float) -> Optional[float]:
    """Per cent: the least time of the work over the device time of the
    kernels that ``portbench/kernels/<metric>.*.json`` name."""
    ms = ctx.stretch.device_ms_of(ctx.cell.kernel_names(metric))
    if ms <= 0:
        return None
    return 100.0 * least_s / (ms / 1e3)


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between ranks."""
    return float(np.percentile(np.asarray(values, np.float64), 100 * q))
