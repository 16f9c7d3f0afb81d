"""Phase timing and tracing.

Counterpart of ``pixelpick_tpu/utils/profiling.py``: :class:`PhaseTimer`
accumulates wall-clock seconds and items per phase (train / vis / val) and
dumps them as ``timing.json``; :func:`trace` wraps ``torch.profiler`` and
writes a Chrome trace when given a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    def __init__(self):
        self._time: Dict[str, float] = defaultdict(float)
        self._items: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, n_items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._time[name] += time.perf_counter() - t0
            self._items[name] += n_items

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "seconds": round(v, 4),
                "items": self._items[k],
                "items_per_sec": round(self._items[k] / v, 3) if v else None,
            }
            for k, v in self._time.items()
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, where there is one, the
    card, written to ``log_dir/trace.json``; a no-op without ``log_dir``."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
