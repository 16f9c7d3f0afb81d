"""Host spans over the whole window, and the profiler over a short stretch
of the same loop after it.

:class:`Spans` times named host spans with ``time.perf_counter`` across the
window (each span's seconds kept), and, while a stretch is profiled, marks
them in the trace with ``record_function`` so that idle gaps of the device
can be named by what the host was doing.

:class:`Stretch` runs ``torch.profiler`` (host and device) over a short
stretch that follows a ``--trace 1`` window, synchronising the device at
both ends; its device events are read from the profiler's raw event list, as
``chip_smoke.py:device_busy`` reads them (the full parse of every host
event takes longer than the stretch). :func:`union_us` is
``chip_smoke.py:union_us``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

MARK = "portbench."


class Spans:
    """``seconds``: each span's seconds in the window; ``traced``: those in
    the profiled stretch (the profiler slows the host there)."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.traced: Dict[str, List[float]] = defaultdict(list)
        self.marking = False

    @contextlib.contextmanager
    def span(self, name: str):
        marking = self.marking
        mark = torch.profiler.record_function(MARK + name) \
            if marking else contextlib.nullcontext()
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                into = self.traced if marking else self.seconds
                into[name].append(time.perf_counter() - t0)

    def drop_last(self, name: str) -> None:
        """Forget the span just closed."""
        (self.traced if self.marking else self.seconds)[name].pop()

    def clear(self) -> None:
        self.seconds.clear()
        self.traced.clear()


def union_us(spans) -> float:
    """The length of the union of sorted (start, end, ...) intervals."""
    busy_us, end = 0.0, float("-inf")
    for s, e, *_ in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us


class Stretch:
    """One profiled stretch: ``start()`` and ``stop()`` around whole steps.
    After ``stop()``: ``seconds`` (wall), ``ops`` [(start_us, end_us, name)]
    of the device, ``marks`` [(start_us, end_us, span name)] of the host,
    and what the caller counted into ``work`` (updates, images, shapes,
    kernel launches)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.seconds: Optional[float] = None
        self.ops: list = []
        self.marks: list = []
        self.work: dict = {}
        self.active = False
        self.done = False

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self.spans.marking = True
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.spans.marking = False
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True

    def parse(self) -> None:
        """Read the device's operations and the host's marks from the
        profiler's raw events."""
        from torch.autograd import DeviceType

        ops, marks = [], []
        for e in self.prof.profiler.kineto_results.events():
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            s = e.start_ns() / 1e3
            end = s + e.duration_ns() / 1e3
            name = e.name()
            if name.startswith(MARK):
                # a host span; the device timeline repeats it as an
                # annotation, which is no operation
                if e.device_type() != DeviceType.CUDA:
                    marks.append((s, end, name[len(MARK):]))
            elif e.device_type() == DeviceType.CUDA:
                ops.append((s, end, name))
        self.ops, self.marks = sorted(ops), sorted(marks)
        self.prof = None

    def busy_us(self) -> float:
        return union_us(self.ops)

    def device_ms_of(self, names) -> float:
        """Device milliseconds of the kernels whose name holds one of
        ``names`` as an identifier (followed by ``<``, ``(`` or the end)."""
        import re

        pat = re.compile(r"\b(?:" + "|".join(map(re.escape, names))
                         + r")(?=[<(]|$)")
        return sum(e - s for s, e, n in self.ops if pat.search(n)) / 1e3

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, by name, and the
        ``n`` longest idle gaps of the device, named by the innermost host
        span running at their middle."""
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in self.ops:
            by_name[name] += (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps, end = [], None
        for s, e, _ in self.ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        named = []
        for lo, hi in gaps:
            mid = (lo + hi) / 2
            inner = [m for m in self.marks if m[0] <= mid <= m[1]]
            name = min(inner, key=lambda m: m[1] - m[0])[2] if inner \
                else "outside_spans"
            named.append([name, (hi - lo) / 1e6])
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}
