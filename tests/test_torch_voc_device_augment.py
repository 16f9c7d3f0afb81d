"""The port's device augmentation on a variable-size dataset (VOC:
``--device_augment --dataset_name voc``; ``pixelpick_tpu_torch/data/
device_pipeline.py``) against the JAX package's variable-size branch
(``pixelpick_tpu/data/device_pipeline.py``: ``_stack_dataset``,
``set_queries``, ``warp_sample(src_hw=...)``), on the CPU, over the JAX
tests' synthetic VOCdevkit tree at ``size_base`` 100 and ``size_crop`` 64
(base-resized images of 75x100, 100x66 and 100x100, staged at 100x100).

Tolerances, as ``tests/test_torch_device_pipeline.py``: the staging exactly;
the warp's labels and query masks exactly, its image within 1e-3 on the
0-255 scale; a whole batch's picks exactly and its x within 1e-4 on the
normalised scale outside the counted rounding ties (1e-4 of the pixels).
A pad region filled with sentinels leaves the warp's output bit-equal.
"""

import os
import pickle as pkl

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.data import device_pipeline as jdp
from pixelpick_tpu.data.voc import VOC2012Segmentation as JaxVOC
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data import device_pipeline as pdp
from pixelpick_tpu_torch.data.voc import VOC2012Segmentation
from tests.test_datasets_cs_voc import _make_voc
from tests.test_torch_device_pipeline import (
    TIE_SHARE, X_TOL, XN_TOL, held_with_ties, photo_draws, picks,
)
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

N_IMAGES = 6
SMALL = dict(n_pixels_by_us=4, size_base=100, size_crop=64, n_workers=2)
GEO = {"random_scale": True, "crop": True, "random_hflip": True}
pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """The JAX and the port's VOC datasets and pipelines over two copies of
    one tree, and some query masks at the base-resized sizes."""
    tmp = tmp_path_factory.mktemp("vocpipe")
    out = {}
    for name, make in (("jax", jax_default_args), ("port", default_args)):
        root = _make_voc(str(tmp / name / "voc"), n=N_IMAGES)
        extra = {} if make is jax_default_args else {"device": "cpu"}
        args = make("voc", dir_dataset=root, dir_checkpoints=str(
            tmp / name / "ck"), device_augment=True, **SMALL, **extra)
        os.makedirs(args.dir_checkpoints, exist_ok=True)
        out[name] = args
    jds, pds = JaxVOC(out["jax"]), VOC2012Segmentation(out["port"])
    rng = np.random.default_rng(3)
    masks = [rng.random(q.shape) < 0.03 for q in jds.queries]
    jpipe = jdp.DevicePipeline(jds, out["jax"])
    ppipe = pdp.DevicePipeline(pds, out["port"], "cpu")
    for p in (jpipe, ppipe):
        p.set_queries(masks)
    return dict(jds=jds, pds=pds, jpipe=jpipe, ppipe=ppipe, masks=masks)


def test_staging_equals_jax(voc):
    """Padded images, ignore-filled labels, the true sizes and the
    False-padded query masks, as JAX's ``_stack_dataset`` and
    ``set_queries`` stage them; the dataset's host cache stays off."""
    jpipe, ppipe = voc["jpipe"], voc["ppipe"]
    assert ppipe.images.shape == (N_IMAGES, 100, 100, 3)
    for k in ("images", "labels", "hw", "queries"):
        np.testing.assert_array_equal(getattr(ppipe, k).numpy(),
                                      np.asarray(getattr(jpipe, k)), k)
    assert sorted(map(tuple, ppipe.hw.tolist())) == sorted(
        [(75, 100), (100, 66), (100, 100)] * 2)
    assert not voc["pds"].cache_images
    assert ppipe.staged_bytes == sum(
        t.numel() * t.element_size() for t in
        (ppipe.images, ppipe.labels, ppipe.queries, ppipe.hw))


# (rs, top, left, flip) per row, for rows of true size 30x44 (padded to
# 40x50), 40x50 and 36x22: a downscale with the crop in the pad of the
# scaled image, an upscale at the bottom-right corner, a flip
WARP_ROWS = [(0.6, 0, 3, False), (1.7, 44, 65, True), (0.8, 4, 0, True)]
TRUE_HW = [(30, 44), (40, 50), (36, 22)]
CROP = (24, 20)


def warp_inputs(sentinel: bool):
    """Staged (x, y, q) padded to 40x50 around the true sizes; the pad
    holds zeros, the ignore index and False, or ``sentinel`` values."""
    rng = np.random.default_rng(4)
    x = np.zeros((3, 40, 50, 3), np.uint8)
    y = np.full((3, 40, 50), 11, np.int32)
    q = np.zeros((3, 40, 50), bool)
    if sentinel:
        x[:], y[:], q[:] = 254, 7, True
    for i, (h, w) in enumerate(TRUE_HW):
        x[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        y[i, :h, :w] = rng.integers(0, 11, (h, w))
        q[i, :h, :w] = rng.random((h, w)) < 0.3
    return x, y, q


def port_warp(x, y, q):
    draws = {k: torch.as_tensor(np.asarray(v)) for k, v in zip(
        ("rs", "top", "left", "flip"),
        zip(*[(np.float32(r[0]), *r[1:]) for r in WARP_ROWS]))}
    return pdp.warp(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(q), draws, CROP,
                    mean_fill=(1.0, 2.0, 3.0), ignore_index=11,
                    src_hw=torch.tensor(TRUE_HW, dtype=torch.int32))


def test_warp_matches_jax_src_hw():
    """Each row against ``warp_sample(src_hw=...)`` at its true size:
    scales down (0.6, 0.8) and up (1.7), with the crop reaching the
    scaled image's pad and the true image's bottom-right corner."""
    x, y, q = warp_inputs(False)
    xp, yp, qp = port_warp(x, y, q)
    for i, ((rs, top, left, flip), (h, w)) in enumerate(zip(WARP_ROWS,
                                                            TRUE_HW)):
        rs = jnp.float32(rs)
        geom = (rs, jnp.floor(h * rs).astype(jnp.int32),
                jnp.floor(w * rs).astype(jnp.int32), jnp.int32(top),
                jnp.int32(left), jnp.bool_(flip))
        xj, yj, qj = jdp.warp_sample(
            jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(q[i]), CROP,
            geom, mean_fill=(1.0, 2.0, 3.0), ignore_index=11,
            src_hw=(jnp.int32(h), jnp.int32(w)))
        np.testing.assert_array_equal(yp[i].numpy(), np.asarray(yj))
        np.testing.assert_array_equal(qp[i].numpy(), np.asarray(qj))
        np.testing.assert_allclose(xp[i].numpy(), np.asarray(xj),
                                   atol=X_TOL, rtol=0)
    # the upscaled row's crop reads up to the true last row and column
    assert (yp[1] != 11).all()


def test_pad_region_is_never_read():
    """The pad filled with sentinels (pixel 254, label 7, mask True): the
    warp's outputs are bit-equal to the zero-padded staging's."""
    ref = port_warp(*warp_inputs(False))
    got = port_warp(*warp_inputs(True))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_draws_from_true_sizes(voc):
    """The port's own crop offsets over 2000 draws per image, each on [0,
    max(int(true extent * rs), crop) - crop]: its true size, not the
    staging's, bounds them, and both ends are reached."""
    ppipe = voc["ppipe"]
    hw = ppipe.hw.repeat_interleave(2000, 0)
    d = ppipe.draw(len(hw), torch.Generator().manual_seed(0), hw)
    rs = d["rs"].numpy()
    for key, src in (("top", hw[:, 0].numpy()), ("left", hw[:, 1].numpy())):
        room = np.maximum(np.floor(src * rs).astype(int), 64) - 64
        off = d[key].numpy()
        assert (off >= 0).all() and (off <= room).all(), key
        assert (off == room).any() and (off[room > 0] == 0).any()


def test_sample_batch_matches_jax(voc):
    """A remainder of 5 padded to 8 (micro-batch 4) on the same draws,
    each row's geometry drawn from its true size: every real row's picks,
    the pad rows' none, x within the tie rule."""
    jpipe, ppipe = voc["jpipe"], voc["ppipe"]
    indices = np.array([4, 1, 0, 5, 2])
    rng = jax.random.PRNGKey(6)
    keys = jax.random.split(rng, 8)
    padded = np.concatenate([indices, indices[-1:].repeat(3)])
    hws = np.asarray(jpipe.hw)[padded]
    geom = {k: [] for k in ("rs", "top", "left", "flip")}
    kps = []
    for key, hw in zip(keys, hws):
        kg, kp = jax.random.split(key)
        rs, _, _, top, left, flip = jdp._sample_geometry(
            kg, (jnp.int32(hw[0]), jnp.int32(hw[1])), (64, 64), GEO)
        for k, v in zip(geom, (rs, top, left, flip)):
            geom[k].append(np.asarray(v))
        kps.append(kp)
    draws = {**{k: torch.from_numpy(np.stack(v)) for k, v in geom.items()},
             **photo_draws(kps, voc["pds"].jitter)}
    jpipe.pad_multiple = ppipe.pad_multiple = 4
    ref = jpipe.sample_batch(indices, rng)
    seen = []

    def drawn(n, generator, hw=None):
        seen.append(hw)
        return draws

    ppipe.draw = drawn
    try:
        got = ppipe.sample_batch(indices, None)
    finally:
        del ppipe.draw
        jpipe.pad_multiple = ppipe.pad_multiple = 1
    np.testing.assert_array_equal(seen[0].numpy(), hws)
    assert got["n_real"] == 5 and got["x"].shape == (8, 64, 64, 3)
    assert int(got["overflow"]) == int(ref["overflow"]) == 0
    jvalid = np.asarray(ref["valid"])
    assert not got["valid"][5:].any() and jvalid.sum() > 20
    for i in range(8):
        assert picks(got["coords"][i], got["labels"][i], got["valid"][i]) \
            == picks(np.asarray(ref["coords"][i]),
                     np.asarray(ref["labels"][i]), jvalid[i])
    n_off, size, worst = held_with_ties(got["x"].numpy(), np.asarray(ref["x"]),
                                        XN_TOL)
    assert n_off <= TIE_SHARE * size, (n_off, size, worst)


def test_voc_device_augment_round(tmp_path):
    """``main_al --dataset_name voc --device_augment --fused_ir
    --pallas_dw`` on the CPU (the kernels' plain versions), bs 4 over 6
    images, one epoch and the round's sweep: the train set staged padded
    beside its true sizes, every update's batch drawn there, finite
    losses, and 4 new non-void picks per image inside it."""
    from pixelpick_tpu_torch.active import driver
    from pixelpick_tpu_torch.models import layers

    root = _make_voc(str(tmp_path / "voc"), n=N_IMAGES)
    args = default_args("voc", dir_dataset=root, device="cpu",
                        dir_checkpoints=str(tmp_path / "run"),
                        width_multiplier=0.5, batch_size=4, n_epochs=1,
                        max_budget=4, pool_batch_size=4, device_augment=True,
                        fused_ir=True, pallas_dw=True, **SMALL)
    os.makedirs(args.dir_checkpoints, exist_ok=True)
    try:
        al = driver.ALModel(args)
        try:
            assert al.device_pipe is not None
            assert tuple(al.device_pipe.images.shape[1:3]) == (100, 100)
            first = [q.copy() for q in al.dataset.queries]
            al()
        finally:
            al.close()
    finally:
        layers.set_depthwise_impl("xla")
    stage = tmp_path / "run" / "0_query"
    for f in ("1_train.png", "1_val.png", "log_train.txt", "log_val.txt",
              "best_miou_model.ckpt", "timing.json", "query_stats.pkl"):
        assert (stage / f).is_file(), f
    rows = (stage / "log_train.txt").read_text().split()[1:]
    assert len(rows) == 1 and np.isfinite(float(rows[0].split(",")[3]))
    with open(tmp_path / "run" / "1_query" / "label.pkl", "rb") as f:
        merged = pkl.load(f)
    for q0, q1, lab in zip(first, merged, al.dataset.list_labels):
        from PIL import Image
        gt = np.asarray(Image.open(lab).resize(q1.shape[::-1],
                                               Image.NEAREST))
        new = q1 & ~q0
        assert q1.shape == q0.shape and int(new.sum()) == 4
        assert not (gt[new] == 255).any()
