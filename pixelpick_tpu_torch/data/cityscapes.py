"""Cityscapes with a one-time downsample cache and the 33 -> 19 label remap
(reference ``datasets/cityscapes.py``; counterpart of
``pixelpick_tpu/data/cityscapes.py``).

The cache ``{dir_dataset}_d{factor}`` holds the images resized bilinearly
and the labels resized nearest and remapped by a 256-entry table; it is
built once, resumably (pairs already written are skipped), and a
``.downsample_complete`` sentinel marks it done. The train set is read at
``--downsample`` (crops 512x1024 at 2, 256x512 at 4), the val set always at
half resolution (``cityscapes.py:25-28``). The initial picks are cached as
one stacked boolean array, ``init_labelled_pixels_d{ds}_{seed}.npy``, in
the JAX package's format. The port runs in one process, which is always
the one that builds the caches.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.data.base import (
    SegDatasetBase, atomic_publish, wait_for_primary_file,
)
from pixelpick_tpu_torch.parallel.distributed import is_primary

IGNORE = 19
# cityscapes labelIds -> 19 train ids (cityscapes.py:137-175)
_CLASS_MAP = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
CROP_SIZES = {2: (512, 1024), 4: (256, 512)}


def classes_to_labels_lut() -> np.ndarray:
    lut = np.full(256, IGNORE, dtype=np.uint8)
    for k, v in _CLASS_MAP.items():
        lut[k] = v
    return lut


def make_downsampled_cityscapes(dir_cityscapes: str, downsample: int = 4,
                                val: bool = False) -> None:
    """Write ``{dir}_d{downsample}``: each image bilinearly and each label
    map nearest resized by ``1/downsample`` of its own size, labels
    remapped (``cityscapes.py:106-134``). Destinations keep each file's
    path relative to the dataset root; pairs whose two outputs exist are
    skipped, so a build killed midway completes on the next run."""
    src_root = dir_cityscapes.rstrip("/")
    dst_root = f"{src_root}_d{downsample}"
    mode = "val" if val else "train"
    lut = classes_to_labels_lut()
    xs = sorted(glob(f"{src_root}/leftImg8bit/{mode}/**/*.png"))
    ys = sorted(glob(f"{src_root}/gtFine/{mode}/**/*_labelIds.png"))
    for px, py in zip(xs, ys):
        out_x = os.path.join(dst_root, os.path.relpath(px, src_root))
        out_y = os.path.join(dst_root, os.path.relpath(py, src_root))
        if os.path.isfile(out_x) and os.path.isfile(out_y):
            continue
        os.makedirs(os.path.dirname(out_x), exist_ok=True)
        os.makedirs(os.path.dirname(out_y), exist_ok=True)
        img = Image.open(px)
        w, h = img.size[0] // downsample, img.size[1] // downsample
        img.resize((w, h), Image.BILINEAR).save(out_x)
        y = np.asarray(Image.open(py).resize((w, h), Image.NEAREST))
        Image.fromarray(lut[y]).save(out_y)


class CityscapesDataset(SegDatasetBase):
    dataset_name = "cityscapes"

    def __init__(self, args, val=False, query=False,
                 generate_init_queries: bool = True):
        super().__init__(args, val=val, query=query)
        ds = args.downsample
        if ds not in CROP_SIZES:
            raise ValueError(f"--downsample {ds}: Cityscapes takes "
                             f"{sorted(CROP_SIZES)}")
        # each instance builds the cache it reads: the val set's at 2
        factor = ds if not val else 2
        dir_dataset = f"{args.dir_dataset}_d{factor}"
        sentinel = f"{dir_dataset}/.downsample_complete"
        if is_primary() and not os.path.isfile(sentinel):
            print(f"Downsampling Cityscapes images (x1/{factor})...")
            for split_val in (False, True):
                make_downsampled_cityscapes(args.dir_dataset,
                                            downsample=factor, val=split_val)
            with open(sentinel, "w") as f:
                f.write("ok\n")
        wait_for_primary_file(sentinel, timeout=7200.0)
        mode = "val" if val else "train"
        self.list_inputs = sorted(
            glob(f"{dir_dataset}/leftImg8bit/{mode}/**/*.png"))
        self.list_labels = sorted(
            glob(f"{dir_dataset}/gtFine/{mode}/**/*_labelIds.png"))
        if not self.list_inputs \
                or len(self.list_inputs) != len(self.list_labels):
            raise ValueError(
                f"{len(self.list_inputs)} images vs {len(self.list_labels)} "
                f"label maps under {dir_dataset}/*/{mode}")
        # the pairing is positional over two sorted globs: the stems must
        # match, or one stray file would shift every later pair
        for px, py in zip(self.list_inputs, self.list_labels):
            sx = os.path.basename(px).replace("_leftImg8bit.png", "")
            sy = os.path.basename(py).replace("_gtFine_labelIds.png", "")
            if sx != sy:
                raise ValueError(f"image/label mismatch: {px} vs {py}")

        self.crop_size = CROP_SIZES[ds]
        # the quarter-resolution train set fits in RAM; the half-resolution
        # val set is read once per epoch, cached as well
        self.cache_images = ds >= 4 or val

        if args.n_pixels_by_us != 0 and not val and generate_init_queries:
            npy = f"{dir_dataset}/init_labelled_pixels_d{ds}_{self.seed}.npy"
            if os.path.isfile(npy):
                stacked = np.load(npy)
                self.queries = [stacked[i] for i in range(stacked.shape[0])]
                self.n_pixels_total = int(stacked.sum())
            else:
                # under data parallelism the other ranks read the
                # primary's queries.pkl (generate_init_queries)
                self.generate_init_queries(
                    args.n_pixels_by_us,
                    f"{self.dir_checkpoints}/0_query/queries.pkl")
                if is_primary():
                    atomic_publish(npy, self._write_npy)
            if is_primary():
                atomic_publish(f"{self.dir_checkpoints}/0_query/label.npy",
                               self._write_npy)

    def _write_npy(self, path: str) -> None:
        # np.save appends '.npy' to a bare path, which would break the
        # tmp-then-rename publish: write through a file object
        with open(path, "wb") as f:
            np.save(f, np.stack(self.queries))
