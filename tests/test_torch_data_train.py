"""The port's train-mode data path (data/augment.py, data/base.py:
``train_sample`` and ``extract_sparse_labels``, data/loader.py: the train
mode) against the JAX package's ``Loader`` on the same synthetic CamVid,
seed and epochs, augmentation on: the batch order, the drop-last rule, and
every batch's x, coords, labels and valid must be equal exactly.

9 train images at batch 4 fire the drop-last rule (9 % 4 == 1); 7 give a
remainder batch of 3. The crop (40x56) is smaller than the 48x64 images, so
both the padding of down-scaled samples and the random crop run.
"""

import numpy as np
import pytest

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.data.factory import get_dataset as jax_get_dataset
from pixelpick_tpu.data.loader import Loader as JaxLoader
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data import base
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from tests.helpers import make_synthetic_camvid

CROP = (40, 56)


def _pair(tmp_path, n_train):
    root = make_synthetic_camvid(str(tmp_path / "camvid"), n_train=n_train,
                                 n_test=2)
    common = dict(dir_dataset=root, n_pixels_by_us=5, max_budget=10,
                  batch_size=4, seed=3)
    ja = jax_default_args(write_files=False, dir_checkpoints=str(
        tmp_path / "jax"), **common)
    pa = default_args(write_files=False, dir_checkpoints=str(
        tmp_path / "port"), device="cpu", **common)
    jd, pd = jax_get_dataset(ja), get_dataset(pa)
    jd.crop_size = pd.crop_size = CROP
    return jd, pd


@pytest.mark.parametrize("n_train", [9, 7])
def test_train_batches_equal_the_jax_loaders(tmp_path, n_train):
    jd, pd = _pair(tmp_path, n_train)
    assert all(pd.geometric_augmentations.values())
    assert all(pd.photometric_augmentations.values())
    for a, b in zip(jd.queries, pd.queries):  # the seeded initial picks
        np.testing.assert_array_equal(a, b)
    jl = JaxLoader(jd, 4, mode="train", shuffle=True, n_workers=2, seed=3)
    pl = Loader(pd, 4, mode="train", shuffle=True, n_workers=2, seed=3)
    assert len(pl) == len(jl) == 2
    assert pl.drop_last == jl.drop_last == (n_train % 4 == 1)
    overflow = base.SPARSE_OVERFLOW_COUNT
    try:
        for epoch in (1, 2):
            plans = [ld.batch_index_plan(epoch) for ld in (jl, pl)]
            assert [list(p) for p in plans[0]] == [list(p) for p in plans[1]]
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            sizes = []
            for jb, pb in zip(jl, pl):
                assert set(pb) == {"x", "coords", "labels", "valid"}
                for k in pb:
                    np.testing.assert_array_equal(pb[k], np.asarray(jb[k]),
                                                  err_msg=f"{k} epoch {epoch}")
                assert pb["x"].dtype == np.uint8
                assert pb["x"].shape[1:] == (*CROP, 3)
                sizes.append(len(pb["x"]))
            assert sizes == ([4, 4] if n_train == 9 else [4, 3])
    finally:
        jl.close()
        pl.close()
    assert base.SPARSE_OVERFLOW_COUNT == overflow


def test_sparse_labels_keep_void_picks_invalid():
    q = np.zeros((6, 7), bool)
    q[1, 2] = q[3, 4] = q[5, 6] = True
    y = np.zeros((6, 7), np.int32)
    y[1, 2], y[3, 4], y[5, 6] = 3, 11, 7
    coords, labels, valid = base.extract_sparse_labels(q, y, 11, 5)
    np.testing.assert_array_equal(coords[:3], [[1, 2], [3, 4], [5, 6]])
    np.testing.assert_array_equal(labels, [3, 11, 7, 0, 0])
    np.testing.assert_array_equal(valid, [True, False, True, False, False])
