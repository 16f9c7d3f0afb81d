"""The device pipeline (``pixelpick_tpu_torch/data/device_pipeline.py``) on
a CUDA card against the same pipeline on the CPU, on the same draws (made
on the card). Skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_device_pipeline_cuda.py

Tolerances are chip_smoke.py phase 14's (``pipeline_card_vs_cpu``): the
picks, their labels, the valid masks and the overflow equal; x on the
normalised scale within 1e-4, but for pixels where a ``round`` sits on a
.5 tie (within one grey level), fewer than 1e-4 of all pixels. TF32 is on
in the process during the card's run, which the pipeline's products must
not use.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch


class ArrayDataset:
    """What ``DevicePipeline`` reads of a dataset, from seeded arrays:
    CamVid's shapes and augmentation settings."""

    def __init__(self, n, hw, crop, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
        self.y = rng.integers(0, 12, (n, *hw)).astype(np.int32)
        self.queries = list(rng.random((n, *hw)) < 0.002)
        self.crop_size, self.k_max, self.ignore_index = crop, 400, 11
        self.mean_fill = (105, 108, 110)
        self.jitter = (0.8, 0.8, 0.8, 0.2)
        self.geometric_augmentations = {"random_scale": True, "crop": True,
                                        "random_hflip": True}
        self.photometric_augmentations = {"random_color_jitter": True,
                                          "random_grayscale": True,
                                          "random_gaussian_blur": True}
        self.cache_images = True

    def __len__(self):
        return len(self.x)

    def _load_x(self, i):
        return self.x[i]

    def _load_y(self, i):
        return self.y[i]


@pytest.mark.cuda
@pytest.mark.parametrize("n_real,crop", [(8, (360, 480)), (7, (256, 320))])
def test_pipeline_card_matches_cpu(n_real, crop):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as cs
    from pixelpick_tpu_torch.data.device_pipeline import DevicePipeline

    ds = ArrayDataset(10, (360, 480), crop)
    args = SimpleNamespace(mean=[0.41, 0.43, 0.43], std=[0.27, 0.29, 0.28])
    pipe = DevicePipeline(ds, args, "cuda")
    pipe.set_queries(ds.queries)
    pipe.pad_multiple = 4
    out = cs.pipeline_card_vs_cpu(pipe, np.arange(n_real)[::-1], seed=1)
    assert out["rows"] == 8 and out["valid_picks"] > 0
    assert out["ok"], out
