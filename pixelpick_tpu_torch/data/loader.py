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
depend on thread scheduling.

Variable-size val and query sets (VOC) load in shape buckets
(``bucket_stride``, ``loader.py:104-206``): at most two, landscape and
portrait, each padded to its images' largest height and width rounded up
to the stride (``pad_sample_to``: x edge-padded, y with the ignore index,
``excluded`` True). Bucket batches carry ``index`` (the dataset index, -1
on the duplicate rows that fill a bucket's last batch) and ``hw`` (each
image's true size, (0, 0) on those rows). The plan is the JAX package's to
the pixel: the pads decide what the network sees.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def pad_sample_to(sample: dict, hw, pad_label: int) -> dict:
    """Pad a val/query sample to a bucket's shape, bottom and right
    (``loader.py:35-56``): x edge-padded (a pad may exceed the image, where
    reflect is undefined), y with ``pad_label`` (the confusion matrix drops
    it), ``excluded`` True (acquisition never picks it)."""
    h, w = sample["x"].shape[:2]
    ph, pw = hw[0] - h, hw[1] - w
    if ph == 0 and pw == 0:
        return sample
    out = dict(sample)
    out["x"] = np.pad(sample["x"], ((0, ph), (0, pw), (0, 0)), mode="edge")
    if "y" in sample:
        out["y"] = np.pad(sample["y"], ((0, ph), (0, pw)),
                          constant_values=pad_label)
    if "excluded" in sample:
        out["excluded"] = np.pad(sample["excluded"], ((0, ph), (0, pw)),
                                 constant_values=True)
    return out


class Loader:
    """mode: 'train' | 'train_dense' | 'val' | 'query'."""

    def __init__(self, dataset, batch_size: int, mode: str = "query",
                 n_workers: int = 4, human_labels: bool = False,
                 prefetch: int = 2, shuffle: bool = False, seed: int = 0,
                 drop_unit: int = None, bucket_stride: int = None,
                 pad_label: int = 255):
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
        self.bucket_stride = bucket_stride
        self.pad_label = pad_label
        self._buckets = None  # [(bucket hw, [indices])], planned on use
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
        if self.bucket_stride is not None:
            return sum(-(-len(idxs) // self.batch_size)
                       for _, idxs in self.bucket_plan())
        n = len(self.dataset) - (1 if self.drop_last else 0)
        return -(-n // self.batch_size)

    def bucket_plan(self):
        """[(bucket (h, w), dataset indices)]: the images grouped by
        orientation (``h >= w`` or not, landscape first), each bucket the
        group's largest height and width rounded up to ``bucket_stride``
        (``loader.py:118-138``); sizes come from ``dataset.sample_hw``."""
        if self._buckets is None:
            s = self.bucket_stride
            hws = [tuple(self.dataset.sample_hw(i, self.mode))
                   for i in range(len(self.dataset))]
            groups = {}
            for i, (h, w) in enumerate(hws):
                groups.setdefault(h >= w, []).append(i)
            self._buckets = [
                ((-(-max(hws[i][0] for i in idxs) // s) * s,
                  -(-max(hws[i][1] for i in idxs) // s) * s), idxs)
                for _, idxs in sorted(groups.items())]
        return self._buckets

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

    def _make_bucket_batch(self, plan) -> Dict[str, np.ndarray]:
        """One bucket batch (``loader.py:176-206``): the samples padded to
        the bucket, a short batch filled with duplicates of its last row
        made inert (y all ``pad_label``, ``excluded`` all True, index -1,
        hw (0, 0)), so that every batch of a bucket has one shape."""
        idxs, hw = plan
        samples = list(self._pool.map(self._fetch, idxs))
        true_hw = [s["x"].shape[:2] for s in samples]
        padded = [pad_sample_to(s, hw, self.pad_label) for s in samples]
        index = list(idxs)
        while len(padded) < self.batch_size:
            dup = dict(padded[-1])
            if "y" in dup:
                dup["y"] = np.full_like(dup["y"], self.pad_label)
            if "excluded" in dup:
                dup["excluded"] = np.ones_like(dup["excluded"])
            padded.append(dup)
            true_hw.append((0, 0))
            index.append(-1)
        batch = collate(padded)
        batch["index"] = np.asarray(index, np.int32)
        batch["hw"] = np.asarray(true_hw, np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.bucket_stride is not None:
            make = self._make_bucket_batch
            plans = [(np.asarray(idxs[i:i + self.batch_size]), hw)
                     for hw, idxs in self.bucket_plan()
                     for i in range(0, len(idxs), self.batch_size)]
        else:
            make = self._make_batch
            plans = self.batch_index_plan(self.epoch)
        batches = iter(plans)
        # keep `prefetch` batches in flight
        futures = [self._batch_pool.submit(make, b)
                   for _, b in zip(range(self.prefetch), batches)]
        while futures:
            batch = futures.pop(0).result()
            nxt = next(batches, None)
            if nxt is not None:
                futures.append(self._batch_pool.submit(make, nxt))
            yield batch
