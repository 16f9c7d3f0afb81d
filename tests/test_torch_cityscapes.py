"""The port's Cityscapes dataset (``pixelpick_tpu_torch/data/cityscapes.py``)
against the JAX package's (``pixelpick_tpu/data/cityscapes.py``) on a
synthetic ``leftImg8bit/``/``gtFine/`` tree (labelIds 0-33 drawn from a
seed, 64x128 images; the tree's path contains "cityscapes", which the
reference's substring path rewrite would corrupt): the label table, the
downsample caches file for file, a build killed midway, the half-resolution
val set, the initial picks and their ``.npy`` caches, and the staging
through the port's device pipeline. Everything is compared exactly.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import pixelpick_tpu.data.cityscapes as jax_cs
from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu_torch import config
from pixelpick_tpu_torch.data import cityscapes as cs
from pixelpick_tpu_torch.data.device_pipeline import DevicePipeline
from pixelpick_tpu_torch.data.factory import get_dataset
from tests.test_datasets_cs_voc import _make_cityscapes


def trees(tmp_path, n=3):
    """Two copies of one synthetic tree: the JAX package's caches go
    beside the first, the port's beside the second."""
    a = _make_cityscapes(str(tmp_path / "jax" / "cityscapes"), n=n)
    b = str(tmp_path / "port" / "cityscapes")
    shutil.copytree(a, b)
    return a, b


def port_args(root, tmp_path, **over):
    args = config.default_args("cs", device="cpu", dir_dataset=root,
                               dir_checkpoints=str(tmp_path / "port_ck"),
                               **over)
    os.makedirs(args.dir_checkpoints, exist_ok=True)
    return args


def jax_args(root, tmp_path, **over):
    args = jax_default_args("cs", dir_dataset=root,
                            dir_checkpoints=str(tmp_path / "jax_ck"), **over)
    os.makedirs(args.dir_checkpoints, exist_ok=True)
    return args


def cache_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


def test_lut_matches_jax():
    np.testing.assert_array_equal(cs.classes_to_labels_lut(),
                                  jax_cs.classes_to_labels_lut())


@pytest.mark.parametrize("downsample", [2, 4])
def test_cache_matches_jax(tmp_path, downsample):
    """The same files under ``{root}_d{ds}`` (and ``_d2`` for val), each
    decoding to the same array; every cached label in 0-19."""
    a, b = trees(tmp_path)
    jds = jax_cs.CityscapesDataset(jax_args(a, tmp_path, n_pixels_by_us=0,
                                            downsample=downsample))
    pds = get_dataset(port_args(b, tmp_path, n_pixels_by_us=0,
                                downsample=downsample))
    assert pds.crop_size == jds.crop_size \
        == {2: (512, 1024), 4: (256, 512)}[downsample]
    assert pds.cache_images == jds.cache_images
    files = cache_files(f"{a}_d{downsample}")
    assert files == cache_files(f"{b}_d{downsample}") and len(files) == 12
    for f in files:
        x = np.asarray(Image.open(f"{a}_d{downsample}/{f}"))
        np.testing.assert_array_equal(
            np.asarray(Image.open(f"{b}_d{downsample}/{f}")), x)
        if "gtFine" in f:
            assert x.max() <= 19
    assert os.path.isfile(f"{b}_d{downsample}/.downsample_complete")
    for i in range(len(pds)):
        np.testing.assert_array_equal(pds._load_y(i), jds._load_y(i))
        np.testing.assert_array_equal(pds._load_x(i), jds._load_x(i))


def test_interrupted_build_resumes(tmp_path):
    """A cache killed midway (a pair and the sentinel missing) is completed
    on the next construction, and equals a straight build."""
    a, b = trees(tmp_path)
    args = port_args(b, tmp_path, n_pixels_by_us=0, downsample=2)
    ds = get_dataset(args)
    n = len(ds.list_inputs)
    straight = [np.asarray(Image.open(p)) for p in ds.list_inputs]
    os.remove(ds.list_inputs[-1])
    os.remove(ds.list_labels[-1])
    os.remove(f"{b}_d2/.downsample_complete")
    ds2 = get_dataset(args)
    assert len(ds2.list_inputs) == n
    assert os.path.isfile(f"{b}_d2/.downsample_complete")
    for p, x in zip(ds2.list_inputs, straight):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), x)


def test_val_is_built_at_half_resolution(tmp_path):
    """--downsample 4: the val instance builds and reads the _d2 cache."""
    _, b = trees(tmp_path)
    ds_val = get_dataset(port_args(b, tmp_path, n_pixels_by_us=5,
                                   downsample=4), val=True)
    assert os.path.isfile(f"{b}_d2/.downsample_complete")
    assert not os.path.exists(f"{b}_d4")
    assert len(ds_val) == 3
    y = ds_val._load_y(0)
    assert y.shape == (32, 64) and y.max() <= 19
    assert ds_val.queries is None


def test_initial_queries_match_jax(tmp_path):
    """The same seeded picks, none void; the .npy caches and
    ``0_query/label.npy`` byte for byte; a JAX-written .npy is read."""
    a, b = trees(tmp_path)
    jds = jax_cs.CityscapesDataset(jax_args(a, tmp_path, n_pixels_by_us=5,
                                            seed=3))
    pargs = port_args(b, tmp_path, n_pixels_by_us=5, seed=3)
    pds = get_dataset(pargs)
    assert pds.n_pixels_total == jds.n_pixels_total == 3 * 5
    for i, (p, j) in enumerate(zip(pds.queries, jds.queries)):
        np.testing.assert_array_equal(p, j)
        assert (pds._load_y(i)[p] != cs.IGNORE).all()
    name = "init_labelled_pixels_d4_3.npy"
    with open(f"{a}_d4/{name}", "rb") as f, open(f"{b}_d4/{name}", "rb") as g:
        assert f.read() == g.read()
    with open(f"{tmp_path}/jax_ck/0_query/label.npy", "rb") as f, \
            open(f"{pargs.dir_checkpoints}/0_query/label.npy", "rb") as g:
        assert f.read() == g.read()

    # a JAX-written cache of other picks is what a new port run reads
    other = np.zeros((3, 16, 32), bool)
    other[:, 5, 7] = other[0, 1, 1] = True
    np.save(f"{a}_d4/{name}", other)
    shutil.copy(f"{a}_d4/{name}", f"{b}_d4/{name}")
    shutil.rmtree(f"{pargs.dir_checkpoints}/0_query")
    again = get_dataset(pargs)
    np.testing.assert_array_equal(np.stack(again.queries), other)
    assert again.n_pixels_total == 4
    np.testing.assert_array_equal(
        np.load(f"{pargs.dir_checkpoints}/0_query/label.npy"), other)


def test_staging_through_the_device_pipeline(tmp_path):
    """The ds-4 cache stages on the port's pipeline; a batch of 2 at the
    16x32 crop has valid picks whose labels are train ids; the host
    loader's sample has the crop's shape."""
    _, b = trees(tmp_path)
    args = port_args(b, tmp_path, n_pixels_by_us=5, device_augment=True)
    ds = get_dataset(args)
    ds.crop_size = (16, 32)  # the synthetic images are 16x32 after d4
    pipe = DevicePipeline(ds, args, "cpu")
    pipe.set_queries(ds.queries)
    assert pipe.images.shape == (3, 16, 32, 3) and not ds._x_cache
    batch = pipe.sample_batch(np.array([0, 1]),
                              torch.Generator().manual_seed(3))
    assert batch["x"].shape == (2, 16, 32, 3)
    assert torch.isfinite(batch["x"]).all()
    labels, valid = batch["labels"], batch["valid"]
    assert valid.any()
    assert (labels[valid] >= 0).all() and (labels[valid] < 19).all()
    # the host loader's sample of the same dataset, at the same crop
    s = ds.train_sample(0, epoch=1)
    assert s["x"].shape == (16, 32, 3) and s["valid"].any()
