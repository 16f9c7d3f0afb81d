"""Threaded prefetching batch loader, val and query modes.

Counterpart of ``pixelpick_tpu/data/loader.py`` (which replaces the
reference's ``torch.utils.data.DataLoader``, ``utils/utils.py:102-108``):
worker threads decode samples while the device computes, and batches are
collated into contiguous NumPy arrays, in dataset order. Val and query
loaders drop no image. The training modes and the shape buckets of
variable-size pools come later (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """mode: 'val' | 'query'."""

    def __init__(self, dataset, batch_size: int, mode: str = "query",
                 n_workers: int = 4, human_labels: bool = False,
                 prefetch: int = 2):
        if mode not in ("val", "query"):
            raise NotImplementedError(f"loader mode {mode!r} is not ported "
                                      "yet (ROADMAP.md, Queue 1)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.human_labels = human_labels
        self.prefetch = max(1, prefetch)
        # separate pools: a batch task must never wait on sample tasks
        # queued behind it in its own pool
        self._pool = ThreadPoolExecutor(max_workers=max(1, n_workers))
        self._batch_pool = ThreadPoolExecutor(max_workers=self.prefetch)

    def close(self) -> None:
        """Release the worker thread pools (idempotent)."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._batch_pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, i: int) -> dict:
        if self.mode == "val":
            return self.dataset.val_sample(i)
        return self.dataset.query_sample(i, human_labels=self.human_labels)

    def _make_batch(self, idxs) -> Dict[str, np.ndarray]:
        return collate(list(self._pool.map(self._fetch, idxs)))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        batches = iter([range(i, min(i + self.batch_size, n))
                        for i in range(0, n, self.batch_size)])
        # keep `prefetch` batches in flight
        futures = [self._batch_pool.submit(self._make_batch, b)
                   for _, b in zip(range(self.prefetch), batches)]
        while futures:
            batch = futures.pop(0).result()
            nxt = next(batches, None)
            if nxt is not None:
                futures.append(self._batch_pool.submit(self._make_batch, nxt))
            yield batch
