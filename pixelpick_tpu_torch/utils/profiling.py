"""Phase timing and the program's tracer.

Counterpart of ``pixelpick_tpu/utils/profiling.py``: :class:`PhaseTimer`
accumulates wall-clock seconds and items per phase (train / vis / val /
stage_ckpt) and dumps them as ``timing.json``; :func:`trace` wraps
``torch.profiler`` and writes a Chrome trace when given a directory.

The tracer records named spans and counters in memory, and is off by
default. Off, :func:`span` returns one shared no-op context and
:func:`count` returns at once: no clock is read and nothing is allocated.
On (:func:`enable`), each span keeps its name, its parent (the innermost
span open when it opened), its start and end, and the calling thread's
CPU time over it (``time.thread_time_ns``). The spans open and close on
the main thread, so wall minus CPU is the time it waited. Timestamps are
``time.time_ns()``, the Unix clock that ``torch.profiler`` stamps its
events with, so a span can be laid over the device operations of any
profile of the same process. Spans and counters, where they are opened:

- ``active/driver.py:ALModel._train_epoch``: ``train.load`` (waiting for
  the next batch, host loader or device pipeline), ``train.upload`` (pad,
  shard, upload), ``train.close`` (the epoch's loss read-back, scores and
  log); ``engine/trainer.py``: ``train.step`` per optimizer update, with
  the children ``train.forward`` (forward and loss), ``train.backward``
  (``zero_grad``, backward, the gradients' all-reduce) and
  ``train.optimizer`` where the update runs eagerly or is captured, and
  ``train.replay`` (the input copy and the replay) where it replays a
  CUDA graph; the counter ``allocator_calls`` (the caching allocator's
  device allocations, frees and retries over each update), and one count
  per step, sparse or dense, of ``train_eager_steps``,
  ``train_graph_captures`` or ``train_graph_replays``
  (``engine/trainer.py:_Graphs``);
- ``ALModel._val``: ``val.load``, ``val.upload``, ``val.close``; the eval
  step: ``val.step`` > ``val.forward`` (forward, argmax, confusion
  matrix), ``val.vis`` (the visualisation maps), and one count per step
  of ``eval_eager_steps``, ``eval_graph_captures`` or
  ``eval_graph_replays`` (how its device work ran, ``engine/trainer.py:
  _Graphs``);
- ``active/selector.py:QuerySelector.__call__``: ``query.load``,
  ``query.upload``, ``query.score``, ``query.readback`` (the ``.cpu()``
  reads and the gather over the ranks), ``query.encode`` (the picks' masks
  and ``codec.encode_query``), ``query.stats`` (``QueryStats.
  update_batch``), ``query.close`` (``stats.save`` and ``label_queries``);
- :meth:`PhaseTimer.phase`: the top-level spans ``train``, ``vis``,
  ``val``, ``stage_ckpt``;
- ``parallel/distributed.py``: ``ranks.all_gather`` (``all_gather_tensor``:
  the height shard's halo rows and gathered maps), ``ranks.all_reduce``
  (``sum_over_ranks``: its sums over the ranks) and ``ranks.gather_object``
  (``all_gather_object``: host objects over gloo),
  each adding 1 to the counter ``collective_calls`` and the bytes this rank
  hands to the collective to ``collective_bytes``; none with one rank.

Every span record carries the rank of the process that recorded it (0
outside a world of ranks, ``set_rank``), and :func:`gather_records` brings
every rank's records and counts to every rank, rank 0 among them. The
ranks of one host share its Unix clock, so their spans' starts can be
compared across ranks.

The program marks its spans in a profile (``record_function``) only inside
its own :func:`trace`, which turns the tracer on for its extent: under a
profiler it did not start, a range would be repeated on the device
timeline as an annotation that a reader of that profile could take for
device work. When the tracer is on, ``timing.json`` also holds each span
name's count and total wall and CPU seconds under ``spans``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    cpu_ns: int
    rank: int = 0


class Tracer:
    """Spans and counters in memory. ``on``: recording; ``marking``: each
    span also a ``record_function`` range (inside :func:`trace`)."""

    def __init__(self):
        self.on = False
        self.marking = False
        self.records: List[SpanRecord] = []
        self.totals: Dict[str, int] = defaultdict(int)
        # (name, n, time_ns) of every count, so that a reader can take a
        # stretch of time
        self.counts: List[tuple] = []
        self.stack: List[str] = []
        self.rank = 0

    def span(self, name: str):
        return _Span(self, name) if self.on else _NOOP

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.totals[name] += n
            self.counts.append((name, n, time.time_ns()))

    def clear(self) -> None:
        self.records.clear()
        self.totals.clear()
        self.counts.clear()


class _Span:
    __slots__ = ("tracer", "name", "parent", "t0", "c0", "mark")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        tr = self.tracer
        self.parent = tr.stack[-1] if tr.stack else None
        tr.stack.append(self.name)
        self.mark = None
        if tr.marking:
            import torch

            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        self.c0 = time.thread_time_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        c1 = time.thread_time_ns()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        tr = self.tracer
        tr.stack.pop()
        tr.records.append(SpanRecord(self.name, self.parent, self.t0, t1,
                                     c1 - self.c0, tr.rank))
        return False


_NOOP = contextlib.nullcontext()
TRACER = Tracer()


def span(name: str):
    """A context that records the span ``name`` when the tracer is on."""
    return TRACER.span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when the tracer is on."""
    TRACER.count(name, n)


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def enabled() -> bool:
    return TRACER.on


def clear() -> None:
    """Forget every recorded span and counter."""
    TRACER.clear()


def set_rank(rank: int) -> None:
    """Tag the spans recorded from now on with ``rank`` (set when the
    process joins a world of ranks, ``parallel/distributed.py``)."""
    TRACER.rank = rank


def spans() -> List[SpanRecord]:
    """The spans recorded so far, in the order they closed."""
    return list(TRACER.records)


def counters() -> Dict[str, int]:
    """Each counter's total."""
    return dict(TRACER.totals)


def count_events() -> List[tuple]:
    """(name, n, time_ns) of each count, in order."""
    return list(TRACER.counts)


def gather_records() -> List[tuple]:
    """Every rank's ``(spans(), count_events())``, in rank order, on every
    rank (rank 0 reads them). A collective over the ranks' host group:
    every rank calls it. One process gets its own, in a list of one."""
    from pixelpick_tpu_torch.parallel import distributed

    return distributed.all_gather_object((spans(), count_events()))


def span_totals(records) -> Dict[str, dict]:
    """Each span name's count and total wall and CPU seconds."""
    out: Dict[str, dict] = {}
    for r in records:
        t = out.setdefault(r.name, {"count": 0, "wall_s": 0.0, "cpu_s": 0.0})
        t["count"] += 1
        t["wall_s"] += (r.end_ns - r.start_ns) / 1e9
        t["cpu_s"] += r.cpu_ns / 1e9
    return {k: {"count": v["count"], "wall_s": round(v["wall_s"], 6),
                "cpu_s": round(v["cpu_s"], 6)} for k, v in out.items()}


def allocator_calls(device):
    """A context that counts ``allocator_calls``: the caching allocator's
    device allocations, frees and retries over the block, when the tracer
    is on and ``device`` is a CUDA device; the shared no-op otherwise."""
    if not TRACER.on or device.type != "cuda":
        return _NOOP
    return _AllocatorCalls(device)


class _AllocatorCalls:
    __slots__ = ("device", "n0")

    def __init__(self, device):
        self.device = device

    def _calls(self) -> int:
        import torch

        st = torch.cuda.memory_stats(self.device)
        return sum(st.get(k, 0) for k in ("num_device_alloc",
                                          "num_device_free",
                                          "num_alloc_retries"))

    def __enter__(self):
        self.n0 = self._calls()
        return self

    def __exit__(self, *exc):
        TRACER.count("allocator_calls", self._calls() - self.n0)
        return False


class PhaseTimer:
    """Wall seconds and items per phase, each phase the top-level span of
    its name; the spans recorded from the timer's creation to its dump go
    into ``timing.json`` when the tracer is on."""

    def __init__(self):
        self._time: Dict[str, float] = defaultdict(float)
        self._items: Dict[str, int] = defaultdict(int)
        self._since_ns = time.time_ns()

    @contextlib.contextmanager
    def phase(self, name: str, n_items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._time[name] += time.perf_counter() - t0
            self._items[name] += n_items

    def summary(self) -> Dict[str, dict]:
        out = {
            k: {
                "seconds": round(v, 4),
                "items": self._items[k],
                "items_per_sec": round(self._items[k] / v, 3) if v else None,
            }
            for k, v in self._time.items()
        }
        if TRACER.on:
            out["spans"] = span_totals(r for r in TRACER.records
                                       if r.start_ns >= self._since_ns)
        return out

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card, written to ``log_dir/trace.json`` (``trace.rank<N>.json`` by rank
    N of several), with the program's spans marked in it (the tracer is on
    for the extent); a no-op without ``log_dir``."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    was_on = TRACER.on
    with profile(activities=acts) as prof:
        TRACER.on = TRACER.marking = True
        try:
            yield
        finally:
            TRACER.marking = False
            TRACER.on = was_on
    from pixelpick_tpu_torch.parallel import distributed

    name = "trace.json" if distributed.world_size() == 1 \
        else f"trace.rank{distributed.rank()}.json"
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, name))
