"""Dataset base: query-mask state, the GT oracle, and pool/val samples.

Counterpart of ``pixelpick_tpu/data/base.py`` (reference
``datasets/base_dataset.py``), the part the query and val paths need:

- ``label_queries``: decode a round's encoded picks, OR-merge them into the
  per-image boolean query masks, optionally dump ``{nth}_query/queries.pkl``
  (``base_dataset.py:24-46``);
- ``update_labelled_queries``: install human-labelled per-pixel maps
  (``base_dataset.py:143-149``);
- ``generate_init_queries``: seeded random initial picks, non-void unless
  ``void_filter`` is off, cached on disk (``camvid.py:50-96``);
- ``val_sample`` / ``query_sample``: uint8 images and int32 labels, decoded
  once and cached in RAM; normalisation happens on the device
  (``engine/trainer.py:normalize_images``).

Training samples (augmentation, sparse-label extraction) come with the
training slice.
"""

from __future__ import annotations

import os
import pickle as pkl
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.active import codec


def atomic_publish(path: str, write_fn) -> None:
    """Write via ``write_fn(tmp_path)`` then atomically rename into place,
    so concurrent readers never observe a torn file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    write_fn(tmp)
    os.replace(tmp, path)


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
        if isinstance(nth_query, int):
            d = f"{self.dir_checkpoints}/{nth_query}_query"
            os.makedirs(d, exist_ok=True)
            with open(f"{d}/queries.pkl", "wb") as f:
                pkl.dump(dict_queries, f)
        return self.n_pixels_total

    def update_labelled_queries(self, labelled_queries: List[np.ndarray]) -> None:
        self.list_labelled_queries = labelled_queries

    def generate_init_queries(self, n_pixels_per_img: int,
                              path_queries: str,
                              void_filter: bool = True) -> None:
        """Seeded random non-void initial picks, cached (camvid.py:50-96).
        ``void_filter=False`` samples uniformly over ALL pixels — the
        custom-dataset semantics (reference custom_dataset.py:66-79)."""
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
        if i not in self._x_cache:
            self._x_cache[i] = np.asarray(
                Image.open(self.list_inputs[i]).convert("RGB"), dtype=np.uint8)
        return self._x_cache[i]

    def _load_y(self, i: int) -> np.ndarray:
        if i not in self._y_cache:
            self._y_cache[i] = np.asarray(Image.open(self.list_labels[i]),
                                          dtype=np.int32)
        return self._y_cache[i]

    def __len__(self):
        return len(self.list_inputs)

    # ----------------------------- samples -----------------------------

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
