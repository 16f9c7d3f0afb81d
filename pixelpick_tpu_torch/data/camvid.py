"""CamVid: 367 train / 233 test, 11 classes, 360x480
(reference ``datasets/camvid.py``; counterpart of
``pixelpick_tpu/data/camvid.py``)."""

from __future__ import annotations

import os
from glob import glob

from pixelpick_tpu_torch.data.base import SegDatasetBase


class CamVidDataset(SegDatasetBase):
    dataset_name = "camvid"

    def __init__(self, args, val=False, query=False,
                 generate_init_queries: bool = True):
        super().__init__(args, val=val, query=query)
        if not os.path.isdir(args.dir_dataset):
            raise FileNotFoundError(f"{args.dir_dataset} does not exist.")
        mode = "test" if val else "train"
        self.list_inputs = sorted(glob(f"{args.dir_dataset}/{mode}/*.png"))
        self.list_labels = sorted(glob(f"{args.dir_dataset}/{mode}annot/*.png"))
        if not self.list_inputs:
            raise FileNotFoundError(f"no images in {args.dir_dataset}/{mode}")
        if self.list_labels or mode != "train":
            # pairing is positional (two sorted globs): verify the file
            # names correspond, or one missing annot shifts every pair
            if len(self.list_inputs) != len(self.list_labels):
                raise ValueError(
                    f"{len(self.list_inputs)} images vs "
                    f"{len(self.list_labels)} label files under "
                    f"{args.dir_dataset}/{mode}[annot]")
            for px, py in zip(self.list_inputs, self.list_labels):
                if os.path.basename(px) != os.path.basename(py):
                    raise ValueError(f"image/label mismatch: {px} vs {py}")
        self.crop_size = (360, 480)
        if args.n_pixels_by_us != 0 and not val and generate_init_queries:
            self.generate_init_queries(
                args.n_pixels_by_us,
                f"{self.dir_checkpoints}/0_query/queries.pkl")
