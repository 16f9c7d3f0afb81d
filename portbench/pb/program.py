"""The port's own spans and counters (``pixelpick_tpu_torch/utils/profiling.
py``), for the per-layer readers that read them.

A reader of them calls :func:`enable` when it is loaded. ``run.py`` loads
the per-layer readers before set-up, and only with ``--trace 1``, so a
``--trace 0`` run keeps the port's tracer off. The tracer stamps its spans
with the Unix clock in ns, as ``torch.profiler`` stamps its events (the
stretch's ``ops`` and ``marks`` are the same clock in us), so the two can
be laid over each other.

- The window's spans are picked by the window's own counts: the last ``n``
  spans of an anchor name (``train.step`` per update, ``val.step`` per eval
  step, ``query.score`` per pool batch) that end before the stretch begins,
  and every span inside their extent.
- The stretch's spans are picked by the clock, against the extent of the
  stretch's device operations.

A port without the tracer records nothing, and every function here then
finds nothing: its readers return None and their metrics are left out.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _tracer():
    try:
        from pixelpick_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def enable() -> None:
    """Turn the port's tracer on, where the port has one."""
    tracer = _tracer()
    if tracer is not None:
        tracer.enable()


def records() -> list:
    tracer = _tracer()
    return tracer.spans() if tracer is not None else []


def count_events() -> list:
    tracer = _tracer()
    return tracer.count_events() if tracer is not None else []


def stretch_start_us(ctx) -> Optional[float]:
    """The first device operation or harness mark of the stretch."""
    st = ctx.stretch
    if st is None:
        return None
    firsts = [seq[0][0] for seq in (st.ops, st.marks) if seq]
    return min(firsts) if firsts else None


def window(ctx, anchor: str, n: int) -> Optional[Tuple[list, list]]:
    """The window's last ``n`` ``anchor`` spans, and every span inside the
    extent from the first one's start to the last one's end; None unless
    the tracer recorded ``n`` of them before the stretch."""
    recs = records()
    start = stretch_start_us(ctx)
    cut = float("inf") if start is None else start * 1e3
    anchors = [r for r in recs if r.name == anchor and r.end_ns <= cut]
    if n <= 0 or len(anchors) < n:
        return None
    anchors = anchors[-n:]
    lo, hi = anchors[0].start_ns, anchors[-1].end_ns
    return anchors, [r for r in recs if lo <= r.start_ns and r.end_ns <= hi]


def waited_ms(spans) -> float:
    """Wall minus the main thread's CPU time, summed, in ms."""
    return sum(r.end_ns - r.start_ns - r.cpu_ns for r in spans) / 1e6


def self_ms(name: str, spans) -> float:
    """The wall ms of the spans named ``name`` less their children's."""
    own = sum(r.end_ns - r.start_ns for r in spans if r.name == name)
    kids = sum(r.end_ns - r.start_ns for r in spans if r.parent == name)
    return (own - kids) / 1e6


def counted(name: str, lo_ns: int, hi_ns: int) -> Optional[int]:
    """The counter ``name``'s counts between two instants; None where it
    counted nothing at all (a CPU run, or a port without it)."""
    events = [(n, t) for c, n, t in count_events() if c == name]
    if not events:
        return None
    return sum(n for n, t in events if lo_ns <= t <= hi_ns)


# ----------------------------- the stretch -----------------------------

def merged(intervals) -> List[Tuple[float, float]]:
    """Sorted, disjoint unions of (start, end, ...) intervals."""
    out: List[List[float]] = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def device_busy(ctx) -> Optional[List[Tuple[float, float]]]:
    """The union of the stretch's device operations (us); None without
    any."""
    st = ctx.stretch
    if st is None or not st.ops:
        return None
    return merged(st.ops)


def gaps_of(busy) -> List[Tuple[float, float]]:
    """The idle intervals between the busy ones."""
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def overlap_us(a, b) -> float:
    """The length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_ms(ctx, names) -> Optional[float]:
    """Device idle ms of the stretch inside the spans named ``names``
    (their children's time included); None without device operations or
    without such spans there."""
    busy = device_busy(ctx)
    if busy is None:
        return None
    lo, hi = busy[0][0], busy[-1][1]
    spans = [(r.start_ns / 1e3, r.end_ns / 1e3) for r in records()
             if r.name in names and r.end_ns / 1e3 > lo
             and r.start_ns / 1e3 < hi]
    if not spans:
        return None
    return overlap_us(gaps_of(busy), merged(spans)) / 1e3


def stretch_units(ctx) -> int:
    """Updates, images or pool batches of the stretch, as the phase counts
    its progress."""
    w = ctx.stretch.work
    return w["to"] - w["from"]


def innermost(spans, lo: float, hi: float) -> List[Tuple[float, float,
                                                         Optional[str]]]:
    """[lo, hi] (us) cut into disjoint pieces, each named by the innermost
    span open there, or None outside every span. The spans are the main
    thread's, so they nest."""
    out = []
    t, stack = lo, []

    def upto(x, name):
        nonlocal t
        x = min(max(x, lo), hi)
        if x > t:
            out.append((t, x, name))
            t = x

    for s, e, name in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            upto(*stack.pop())
        upto(s, stack[-1][1] if stack else None)
        stack.append((e, name))
    while stack:
        upto(*stack.pop())
    upto(hi, None)
    return out


def idle_by_span(ctx) -> Optional[Dict[Optional[str], float]]:
    """Device idle ms of the stretch, by the innermost program span at
    each idle instant (None: inside no span); None without device
    operations."""
    busy = device_busy(ctx)
    if busy is None:
        return None
    gaps, lo, hi = gaps_of(busy), busy[0][0], busy[-1][1]
    spans = [(r.start_ns / 1e3, r.end_ns / 1e3, r.name) for r in records()
             if r.end_ns / 1e3 > lo and r.start_ns / 1e3 < hi]
    out: Dict[Optional[str], float] = {}
    pieces = innermost(spans, lo, hi)
    i = 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            out[name] = out.get(name, 0.0) + (min(e, g1) - max(s, g0)) / 1e3
            j += 1
    return out
