"""Dataset base: query-mask state, the GT oracle, and pool/val samples.

Counterpart of ``pixelpick_tpu/data/base.py`` (reference
``datasets/base_dataset.py``), the part the query and val paths need:

- ``label_queries``: decode a round's encoded picks, OR-merge them into the
  per-image boolean query masks, optionally dump ``{nth}_query/queries.pkl``
  (``base_dataset.py:24-46``);
- ``update_labelled_queries``: install human-labelled per-pixel maps
  (``base_dataset.py:143-149``); ``set_human_inputs`` points the dataset at
  the merged human-labelled images and maps of ``cli/train.py``
  (``base.py:188-210``);
- ``generate_init_queries``: seeded random initial picks, non-void unless
  ``void_filter`` is off, cached on disk (``camvid.py:50-96``);
- ``train_sample``: co-augmented (``data/augment.py``) image, label and
  query mask, then the labelled pixels as sparse coordinates
  (``extract_sparse_labels``) for the sparse-label train step; with
  ``human_labels`` the coordinates and labels of the augmented human-label
  map (``extract_sparse_from_map``); or with ``fully_sup`` the augmented
  dense label map for the dense step (``base.py:286-325``);
- ``val_sample`` / ``query_sample``: uint8 images and int32 labels, decoded
  once and cached in RAM (``cache_images``); normalisation happens on the
  device (``engine/trainer.py:normalize_images``).
"""

from __future__ import annotations

import os
import pickle as pkl
import random
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.parallel.distributed import is_primary


def wait_for_primary_file(path: str, timeout: float = 1800.0) -> None:
    """Under data parallelism, block a rank other than the primary until
    the primary has published ``path`` (``atomic_publish``); a no-op on
    the primary (JAX ``data/base.py:38-52``). The path must lie on a
    filesystem every rank sees."""
    if is_primary():
        return
    deadline = time.time() + timeout
    while not os.path.isfile(path):
        if time.time() > deadline:
            raise TimeoutError(f"waited {timeout:.0f} s for the primary rank "
                               f"to publish {path}")
        time.sleep(0.2)


def atomic_publish(path: str, write_fn) -> None:
    """Write via ``write_fn(tmp_path)`` then atomically rename into place,
    so concurrent readers never observe a torn file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    write_fn(tmp)
    os.replace(tmp, path)


# Sparse-extraction overflow counters: labelled pixels dropped because a
# crop held more than k_max of them. The reference's dense path never drops
# a label, so k_max carries headroom that makes this unreachable and the
# tests hold both at 0. COUNT counts events (crops), PIXELS dropped pixels.
SPARSE_OVERFLOW_COUNT = 0
SPARSE_OVERFLOW_PIXELS = 0


def _padded(ys, xs, labels, valid, k_max: int, what: str):
    """The first k_max picks as (coords (k_max, 2), labels (k_max,), valid
    (k_max,)), zero-padded; an overflow is counted and warned about."""
    global SPARSE_OVERFLOW_COUNT, SPARSE_OVERFLOW_PIXELS
    if len(ys) > k_max:
        SPARSE_OVERFLOW_COUNT += 1
        SPARSE_OVERFLOW_PIXELS += len(ys) - k_max
        warnings.warn(f"sparse-label overflow{what}: {len(ys)} labelled "
                      f"pixels in crop but k_max={k_max}; "
                      f"{len(ys) - k_max} dropped")
    n = min(len(ys), k_max)
    coords = np.zeros((k_max, 2), np.int32)
    out_labels = np.zeros((k_max,), np.int32)
    out_valid = np.zeros((k_max,), bool)
    coords[:n, 0] = ys[:n]
    coords[:n, 1] = xs[:n]
    out_labels[:n] = labels[:n]
    out_valid[:n] = valid[:n]
    return coords, out_labels, out_valid


def extract_sparse_labels(queries: np.ndarray, y: np.ndarray,
                          ignore_index: int, k_max: int):
    """Labelled-pixel coordinates and labels after augmentation, padded to
    k_max (``base.py:76-102``). Picks whose label is void are kept but not
    valid: CE ``ignore_index`` on the densified path."""
    ys, xs = np.nonzero(queries)
    labels = y[ys, xs].astype(np.int32)
    return _padded(ys, xs, labels, labels != ignore_index, k_max, "")


def extract_sparse_from_map(labelled_map: np.ndarray, ignore_index: int,
                            k_max: int):
    """Human-label mode: the coordinates and labels of every non-void pixel
    of an (augmented) merged label map, padded to k_max
    (``base.py:105-126``)."""
    ys, xs = np.nonzero(labelled_map != ignore_index)
    labels = labelled_map[ys, xs].astype(np.int32)
    return _padded(ys, xs, labels, np.ones(len(ys), bool), k_max,
                   " (human labels)")


class SegDatasetBase:
    dataset_name: str = "base"

    def __init__(self, args, val: bool = False, query: bool = False):
        self.args = args
        self.val = val
        self.query = query
        self.seed = args.seed
        self.ignore_index = args.ignore_index
        self.n_classes = args.n_classes
        self.mean = list(args.mean)
        self.std = list(args.std)
        self.dir_checkpoints = args.dir_checkpoints

        self.list_inputs: List[str] = []
        self.list_labels: List[str] = []
        self.queries: Optional[List[np.ndarray]] = None
        self.list_labelled_queries: Optional[List[np.ndarray]] = None
        self.n_pixels_total: int = -1
        self.crop_size: Tuple[int, int] = (0, 0)
        self._x_cache: dict = {}
        self._y_cache: dict = {}
        # decoded images and labels stay in RAM unless a subclass or the
        # device pipeline's staging turns this off
        self.cache_images = True
        augs = getattr(args, "augmentations", {})
        self.geometric_augmentations = dict(augs.get("geometric", {}))
        self.photometric_augmentations = dict(augs.get("photometric", {}))
        self.mean_fill = tuple((np.array(self.mean) * 255.0)
                               .astype(np.uint8).tolist())
        self.jitter = (0.8, 0.8, 0.8, 0.2)  # base_dataset.py:131
        # sparse coordinate budget per image: random scale up to 2x with
        # nearest-resized masks repeats a labelled pixel up to 4 times, all
        # possibly inside the crop, so 4x the nominal budget never truncates
        base_k = int(max(args.max_budget + max(args.n_init_pixels, 0),
                         args.n_pixels_by_us, 1))
        headroom = 4 if self.geometric_augmentations.get("random_scale") \
            else 1
        self.k_max = base_k * headroom

    # ----------------------------- state -----------------------------

    def label_queries(self, dict_queries: Dict[str, dict], nth_query=None) -> int:
        if len(dict_queries) != len(self.queries):
            raise ValueError(f"{len(dict_queries)} encoded queries for "
                             f"{len(self.queries)} images")
        new_masks = codec.decode_queries(dict_queries)
        previous = self.n_pixels_total
        self.queries = [np.logical_or(p, n) for p, n in zip(self.queries, new_masks)]
        self.n_pixels_total = int(sum(int(q.sum()) for q in self.queries))
        print(f"# labelled pixels is changed from {previous} to "
              f"{self.n_pixels_total} (delta: {self.n_pixels_total - previous})")
        if isinstance(nth_query, int) and is_primary():
            d = f"{self.dir_checkpoints}/{nth_query}_query"
            os.makedirs(d, exist_ok=True)
            with open(f"{d}/queries.pkl", "wb") as f:
                pkl.dump(dict_queries, f)
        return self.n_pixels_total

    def update_labelled_queries(self, labelled_queries: List[np.ndarray]) -> None:
        self.list_labelled_queries = labelled_queries

    def set_human_inputs(self, inputs: List[str],
                         labelled_maps: List[np.ndarray]) -> None:
        """Point the dataset at the merged human-labelled images and their
        label maps (``base.py:188-210``), before any loader is built on it.
        Human mode reads no label file: the label list is cleared, so a stray
        read fails loudly instead of reading another image's labels."""
        if len(inputs) != len(labelled_maps):
            raise ValueError(f"{len(inputs)} inputs for "
                             f"{len(labelled_maps)} labelled maps")
        for p, m in zip(inputs, labelled_maps):
            if not os.path.exists(p):
                raise FileNotFoundError(p)
            if m.ndim != 2:
                raise ValueError(f"{p}: label map of shape {m.shape}")
        self.list_inputs = list(inputs)
        self.list_labels = []
        if hasattr(self, "has_labels"):
            self.has_labels = False
        self.queries = None
        self.n_pixels_total = int(sum(int((m != self.ignore_index).sum())
                                      for m in labelled_maps))
        self._x_cache.clear()
        self._y_cache.clear()
        self.update_labelled_queries(list(labelled_maps))

    def generate_init_queries(self, n_pixels_per_img: int,
                              path_queries: str,
                              void_filter: bool = True) -> None:
        """Seeded random non-void initial picks, cached (camvid.py:50-96).
        ``void_filter=False`` samples uniformly over ALL pixels — the
        custom-dataset semantics (reference custom_dataset.py:66-79).
        Under data parallelism the primary publishes the file and the other
        ranks read it."""
        wait_for_primary_file(path_queries)
        if os.path.isfile(path_queries):
            with open(path_queries, "rb") as f:
                self.queries = codec.decode_queries(pkl.load(f))
        else:
            dict_queries: Dict[str, dict] = {}
            rng = np.random.RandomState(self.seed)
            for i in range(len(self.list_inputs)):
                label = self._load_y(i)
                h, w = label.shape
                if void_filter:
                    cand = np.nonzero(label.reshape(-1) != self.ignore_index)[0]
                else:
                    cand = np.arange(h * w)
                chosen = rng.choice(cand, min(n_pixels_per_img, len(cand)),
                                    replace=False)
                q = np.zeros(h * w, bool)
                q[chosen] = True
                dict_queries.update(codec.encode_query(
                    self.list_inputs[i], (h, w), q.reshape(h, w)))

            def _write(p, _q=dict_queries):
                with open(p, "wb") as f:
                    pkl.dump(_q, f)

            atomic_publish(path_queries, _write)
            self.queries = codec.decode_queries(dict_queries)
        self.n_pixels_total = int(sum(int(q.sum()) for q in self.queries))
        print("total number of labelled pixels selected as queries:",
              self.n_pixels_total)

    # ----------------------------- IO -----------------------------

    def _load_x(self, i: int) -> np.ndarray:
        if i in self._x_cache:
            return self._x_cache[i]
        x = np.asarray(Image.open(self.list_inputs[i]).convert("RGB"),
                       dtype=np.uint8)
        if self.cache_images:
            self._x_cache[i] = x
        return x

    def _load_y(self, i: int) -> np.ndarray:
        if i in self._y_cache:
            return self._y_cache[i]
        y = np.asarray(Image.open(self.list_labels[i]), dtype=np.int32)
        if self.cache_images:
            self._y_cache[i] = y
        return y

    def __len__(self):
        return len(self.list_inputs)

    # ----------------------------- samples -----------------------------

    def sample_rng(self, epoch: int, index: int) -> random.Random:
        return random.Random(
            (int(self.seed) * 1_000_003 + int(epoch)) * 1_000_003 + int(index))

    def train_sample(self, i: int, epoch: int, human_labels: bool = False,
                     fully_sup: bool = False) -> dict:
        """Augmented sample with sparse labels: x uint8 (H, W, 3), coords
        (k_max, 2), labels (k_max,), valid (k_max,); with ``human_labels``
        taken from the merged label map (an all-void y rides along through
        the augmentation; no label file is read); with ``fully_sup`` the
        same augmentation without query masks, returning x and the dense
        label map y int32 (H, W)."""
        from pixelpick_tpu_torch.data.augment import (
            geometric_augment, photometric_augment,
        )

        rng = self.sample_rng(epoch, i)
        x_arr = self._load_x(i)
        if human_labels:
            y_arr = np.full(x_arr.shape[:2], self.ignore_index, np.int32)
        else:
            y_arr = self._load_y(i).astype(np.int32)
        queries = None if (fully_sup or human_labels) else self.queries[i]
        labelled = self.list_labelled_queries[i] if human_labels else None
        x, y_np, q_np, l_np = geometric_augment(
            Image.fromarray(x_arr), Image.fromarray(y_arr, mode="I"),
            queries, labelled, rng, crop_size=self.crop_size,
            mean_fill=self.mean_fill, ignore_index=self.ignore_index,
            enabled=self.geometric_augmentations)
        x = photometric_augment(x, rng, jitter=self.jitter,
                                enabled=self.photometric_augmentations)
        x_np = np.asarray(x, dtype=np.uint8)
        if fully_sup:
            return {"x": x_np, "y": y_np}
        if human_labels:
            coords, labels, valid = extract_sparse_from_map(
                l_np, self.ignore_index, self.k_max)
        else:
            coords, labels, valid = extract_sparse_labels(
                q_np, y_np, self.ignore_index, self.k_max)
        return {"x": x_np, "coords": coords, "labels": labels,
                "valid": valid}

    def val_sample(self, i: int) -> dict:
        return {"x": self._load_x(i), "y": self._load_y(i)}

    def query_sample(self, i: int, human_labels: bool = False) -> dict:
        """Pool-scoring sample. ``excluded`` marks already-labelled pixels
        (query.py:194-201); void exclusion happens on the device from y."""
        x = self._load_x(i)
        if human_labels:
            m = self.list_labelled_queries[i]
            excluded = m != self.ignore_index
            y = np.zeros(excluded.shape, np.int32)  # no void info available
        else:
            excluded = self.queries[i]
            y = self._load_y(i)
        return {"x": x, "y": y.astype(np.int32), "excluded": excluded}
