"""PASCAL VOC 2012 segmentation (reference ``datasets/voc.py``; counterpart
of ``pixelpick_tpu/data/voc.py``).

What differs from the shared base, as in the reference's VOC class:

- images vary in size. Train and query samples resize the longer side to
  ``size_base`` (400; ``compute_base_size``); train samples then random-
  scale, crop to ``size_crop`` (320) and flip, with a milder colour jitter
  (0.1/0.1/0.1/0.1, ``voc.py:176``); query samples keep the base size with
  no geometric augmentation; validation keeps each image's own size. The
  val and query loaders batch them in shape buckets
  (``data/loader.py:Loader``, ``bucket_stride``), which ``sample_hw``
  plans from the image headers alone;
- the initial picks are raw per-image bool masks at the base-resized size,
  drawn from ``np.random.RandomState(seed)`` over the non-void pixels and
  cached as ``init_labelled_pixels_{seed}.pkl`` beside the data and
  ``0_query/label.pkl`` (``voc.py:47-66``); ``label_queries`` merges a
  round's picks, raw masks or the encoded dict, and dumps ``label.pkl``.

Layout: a standard ``VOCdevkit/VOC2012`` (or its ``VOC2012`` directory)
with ``ImageSets/Segmentation/{train,val}.txt``, ``JPEGImages/*.jpg`` and
``SegmentationClass/*.png`` (palette-mode labels, 255 void), or with
``--use_augmented_dataset`` the name-matched ``{root}/images`` /
``{root}/annot`` train pairs (``voc.py:214-226``).
"""

from __future__ import annotations

import os
import pickle as pkl
from glob import glob
from typing import List, Tuple

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.active import codec
from pixelpick_tpu_torch.data.augment import (
    geometric_augment, photometric_augment,
)
from pixelpick_tpu_torch.data.base import (
    SegDatasetBase, atomic_publish, extract_sparse_from_map,
    extract_sparse_labels, wait_for_primary_file,
)
from pixelpick_tpu_torch.parallel.distributed import is_primary


def compute_base_size(h: int, w: int, size_base: int) -> Tuple[int, int]:
    """(h, w) with the longer side resized to ``size_base``
    (``voc.py:126-133``)."""
    if w > h:
        return int(float(h) / w * size_base), size_base
    return size_base, int(float(w) / h * size_base)


def find_voc_split(dir_dataset: str, val: bool):
    """(images, labels) of the train or val list of a VOC2012 layout."""
    root = None
    for cand in (os.path.join(dir_dataset, "VOCdevkit", "VOC2012"),
                 dir_dataset):
        if os.path.isdir(os.path.join(cand, "ImageSets", "Segmentation")):
            root = cand
            break
    if root is None:
        raise FileNotFoundError(f"no VOC2012 layout under {dir_dataset}")
    split = "val" if val else "train"
    with open(os.path.join(root, "ImageSets", "Segmentation",
                           f"{split}.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    imgs = [os.path.join(root, "JPEGImages", f"{n}.jpg") for n in names]
    labs = [os.path.join(root, "SegmentationClass", f"{n}.png")
            for n in names]
    return imgs, labs


class VOC2012Segmentation(SegDatasetBase):
    dataset_name = "voc"
    variable_size = True  # images differ in size: bucketed val and query

    def __init__(self, args, val=False, query=False,
                 generate_init_queries: bool = True):
        super().__init__(args, val=val, query=query)
        self.size_base = args.size_base
        self.size_crop = (args.size_crop, args.size_crop)
        self.crop_size = self.size_crop  # the train batches' shape
        self.stride_total = args.stride_total
        self.jitter = (0.1, 0.1, 0.1, 0.1)  # voc.py:176

        if args.use_augmented_dataset and not val:
            root = args.dir_augmented_dataset
            if not os.path.isdir(root):
                raise FileNotFoundError(
                    f"--use_augmented_dataset: no directory at {root} "
                    "(set --dir_augmented_dataset)")
            imgs = sorted(glob(f"{root}/images/*"))
            labs = sorted(glob(f"{root}/annot/*"))
            if not imgs or len(imgs) != len(labs):
                raise ValueError(f"{len(imgs)} images vs {len(labs)} label "
                                 f"maps under {root}")
            for p_img, p_lab in zip(imgs, labs):  # voc.py:224
                if os.path.basename(p_img).split(".")[0] \
                        != os.path.basename(p_lab).split(".")[0]:
                    raise ValueError(f"image/label mismatch: {p_img} vs "
                                     f"{p_lab}")
            self.list_inputs, self.list_labels = imgs, labs
        else:
            self.list_inputs, self.list_labels = find_voc_split(
                args.dir_dataset, val)
        print("# images:", len(self.list_inputs))
        self.cache_images = False  # variable sizes: decode on demand

        if query:  # voc.py:35-38
            for k in ("random_scale", "crop", "random_hflip"):
                self.geometric_augmentations[k] = False

        n_px = args.n_pixels_by_us
        init_n = args.n_init_pixels if args.n_init_pixels > 0 else n_px
        if n_px != 0 and not val and generate_init_queries:
            path = f"{args.dir_dataset}/init_labelled_pixels_{self.seed}.pkl"
            wait_for_primary_file(path)  # data parallelism: the primary writes
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    self.queries = pkl.load(f)
            else:
                self.queries = self._draw_init_queries(init_n)
                atomic_publish(path, self._write_queries)
                atomic_publish(f"{self.dir_checkpoints}/0_query/label.pkl",
                               self._write_queries)
            self.n_pixels_total = int(sum(int(q.sum()) for q in self.queries))
            print("# labelled pixels used for training:", self.n_pixels_total)

    def _draw_init_queries(self, n: int) -> List[np.ndarray]:
        """``n`` non-void pixels per image at the base-resized size, the
        images in order from one ``RandomState(seed)`` (``voc.py:47-66``)."""
        rng = np.random.RandomState(self.seed)
        qs = []
        for p in self.list_labels:
            label = Image.open(p)
            w, h = label.size
            h, w = compute_base_size(h, w, self.size_base)
            lab = np.asarray(label.resize((w, h), Image.NEAREST), np.int32)
            cand = np.nonzero(lab.reshape(-1) != 255)[0]
            chosen = rng.choice(cand, min(n, len(cand)), replace=False)
            q = np.zeros(h * w, bool)
            q[chosen] = True
            qs.append(q.reshape(h, w))
        return qs

    def _write_queries(self, path: str) -> None:
        with open(path, "wb") as f:
            pkl.dump(self.queries, f)

    def label_queries(self, queries, nth_query=None) -> int:
        """OR-merge a round's picks (raw masks, or the encoded dict) into
        the masks; with ``nth_query`` dump them to
        ``{nth_query}_query/label.pkl`` (``voc.py:108-124``)."""
        if isinstance(queries, dict):
            queries = codec.decode_queries(queries)
        if len(queries) != len(self.queries):
            raise ValueError(f"{len(queries)} query masks for "
                             f"{len(self.queries)} images")
        previous = self.n_pixels_total
        self.queries = [np.logical_or(q, m)
                        for q, m in zip(queries, self.queries)]
        self.n_pixels_total = int(sum(int(q.sum()) for q in self.queries))
        if isinstance(nth_query, int) and is_primary():
            d = f"{self.dir_checkpoints}/{nth_query}_query"
            os.makedirs(d, exist_ok=True)
            self._write_queries(f"{d}/label.pkl")
        print(f"# labelled pixels is changed from {previous} to "
              f"{self.n_pixels_total} (delta: {self.n_pixels_total - previous})")
        return self.n_pixels_total

    # --------------------------- samples ---------------------------

    def sample_hw(self, i: int, mode: str) -> Tuple[int, int]:
        """The (h, w) a val or query sample will have, read from the image
        header alone (no pixel is decoded)."""
        with Image.open(self.list_inputs[i]) as im:
            w, h = im.size
        if mode == "query":
            return compute_base_size(h, w, self.size_base)
        return h, w

    def _base_resized(self, i: int):
        x = Image.open(self.list_inputs[i]).convert("RGB")
        y = Image.open(self.list_labels[i])
        w, h = x.size
        h, w = compute_base_size(h, w, self.size_base)
        return x.resize((w, h), Image.BILINEAR), y.resize((w, h),
                                                         Image.NEAREST)

    def train_sample(self, i: int, epoch: int, human_labels: bool = False,
                     fully_sup: bool = False) -> dict:
        rng = self.sample_rng(epoch, i)
        x, y = self._base_resized(i)
        queries = None if (fully_sup or human_labels) else self.queries[i]
        labelled = self.list_labelled_queries[i] if human_labels else None
        x, y_np, q_np, l_np = geometric_augment(
            x, y, queries, labelled, rng, crop_size=self.size_crop,
            mean_fill=self.mean_fill, ignore_index=self.ignore_index,
            enabled=self.geometric_augmentations)
        if not self.query:
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
        x = np.asarray(Image.open(self.list_inputs[i]).convert("RGB"),
                       np.uint8)
        y = np.asarray(Image.open(self.list_labels[i]), np.int32)
        return {"x": x, "y": y}

    def query_sample(self, i: int, human_labels: bool = False) -> dict:
        x, y = self._base_resized(i)
        x, y = np.asarray(x, np.uint8), np.asarray(y, np.int32)
        if human_labels:
            excluded = self.list_labelled_queries[i] != self.ignore_index
            y = np.zeros(excluded.shape, np.int32)
        else:
            excluded = self.queries[i]
        return {"x": x, "y": y, "excluded": excluded}
