"""User-supplied dataset configured via YAML (reference
``datasets/custom_dataset.py``; counterpart of
``pixelpick_tpu/data/custom.py``): train images under ``{dir_dataset}/train``
(labels optional — human-annotation mode), val under ``{dir_dataset}/val``.
Initial queries are random over *all* pixels (no void filtering,
``custom_dataset.py:66-79``)."""

from __future__ import annotations

from glob import glob

import numpy as np
from PIL import Image

from pixelpick_tpu_torch.data.base import SegDatasetBase


class CustomDataset(SegDatasetBase):
    dataset_name = "custom"

    def __init__(self, args, val=False, query=False,
                 generate_init_queries: bool = True):
        super().__init__(args, val=val, query=query)
        mode = "val" if val else "train"
        exts = ("png", "jpg", "jpeg")
        self.list_inputs = sorted(p for e in exts
                                  for p in glob(f"{args.dir_dataset}/{mode}/*.{e}"))
        if not self.list_inputs:
            raise FileNotFoundError(f"no images in {args.dir_dataset}/{mode}")
        self.list_labels = sorted(p for e in exts
                                  for p in glob(f"{args.dir_dataset}/{mode}annot/*.{e}"))
        self.has_labels = len(self.list_labels) == len(self.list_inputs)
        self.crop_size = tuple(getattr(args, "crop_size", None)
                               or self._infer_size())

        if args.n_pixels_by_us != 0 and not val and generate_init_queries:
            self.generate_init_queries(
                args.n_pixels_by_us,
                f"{self.dir_checkpoints}/0_query/queries.pkl",
                void_filter=False)

    def _infer_size(self):
        w, h = Image.open(self.list_inputs[0]).size
        return (h, w)

    def _load_y(self, i):
        if not self.has_labels:
            # human-annotation mode: no GT; treat everything as void
            x = self._load_x(i)
            return np.full(x.shape[:2], self.ignore_index, np.int32)
        return super()._load_y(i)
