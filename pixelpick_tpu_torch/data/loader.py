"""Threaded prefetching batch loader: train, val and query modes.

Counterpart of ``pixelpick_tpu/data/loader.py`` (which replaces the
reference's ``torch.utils.data.DataLoader``, ``utils/utils.py:102-108``):
worker threads decode samples while the device computes, and batches are
collated into contiguous NumPy arrays. The train mode shuffles per epoch
(``batch_index_plan``, ``loader.py:143-161``) and drops the last shuffled
image only when ``n % drop_unit == 1`` (the reference's drop-last,
``utils/utils.py:107``, at the update size: ``drop_unit`` is the batch size,
or the micro-batch size of a megabatch schedule, ``loader.py:66-88``); val
and query loaders keep dataset order and drop nothing. The train modes are
``train`` (sparse labels) and ``train_dense`` (the full label map, for the
fully supervised step); with ``human_labels`` the train mode reads the
merged human-label maps and the query mode excludes their pixels.
Augmentation draws from a per-(epoch, index) stream, so batches do not
depend on thread scheduling. The shape buckets of
variable-size pools come later (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """mode: 'train' | 'train_dense' | 'val' | 'query'."""

    def __init__(self, dataset, batch_size: int, mode: str = "query",
                 n_workers: int = 4, human_labels: bool = False,
                 prefetch: int = 2, shuffle: bool = False, seed: int = 0,
                 drop_unit: int = None):
        if mode not in ("train", "train_dense", "val", "query"):
            raise NotImplementedError(f"loader mode {mode!r} is not ported "
                                      "yet (ROADMAP.md, Queue 1)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.human_labels = human_labels
        self.prefetch = max(1, prefetch)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        # the drop-last rule at the update size: a megabatch schedule
        # (--micro_batch_size M) drops what the reference's bs-M run drops
        self.drop_unit = drop_unit or batch_size
        self.drop_last = (mode in ("train", "train_dense")
                          and len(dataset) % self.drop_unit == 1)
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
        n = len(self.dataset) - (1 if self.drop_last else 0)
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def batch_index_plan(self, epoch: int) -> List[np.ndarray]:
        """The epoch's batches of dataset indices: shuffled by
        ``seed * 100003 + epoch`` when shuffling, the last image dropped
        under the drop-last rule."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed * 100003 + epoch).shuffle(order)
        if self.drop_last:
            # the rule fires for one trailing image only, so dropping the
            # last shuffled image is the reference's dropped batch at any
            # drop_unit
            order = order[:-1]
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def _fetch(self, i: int) -> dict:
        if self.mode == "train":
            return self.dataset.train_sample(
                i, self.epoch, human_labels=self.human_labels)
        if self.mode == "train_dense":
            return self.dataset.train_sample(i, self.epoch, fully_sup=True)
        if self.mode == "val":
            return self.dataset.val_sample(i)
        return self.dataset.query_sample(i, human_labels=self.human_labels)

    def _make_batch(self, idxs) -> Dict[str, np.ndarray]:
        return collate(list(self._pool.map(self._fetch, idxs)))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = iter(self.batch_index_plan(self.epoch))
        # keep `prefetch` batches in flight
        futures = [self._batch_pool.submit(self._make_batch, b)
                   for _, b in zip(range(self.prefetch), batches)]
        while futures:
            batch = futures.pop(0).result()
            nxt = next(batches, None)
            if nxt is not None:
                futures.append(self._batch_pool.submit(self._make_batch, nxt))
            yield batch
