"""The port's device augmentation (``pixelpick_tpu_torch/data/
device_pipeline.py``, ``--device_augment``) against the JAX package's
(``pixelpick_tpu/data/device_pipeline.py``) on the same inputs and the same
random draws, on the CPU.

JAX draws from keys and the port from ``torch.Generator``s, so the tests
feed the port the draws that JAX's keys give: ``jax_draws`` splits the keys
exactly as ``batch_impl``, ``_sample_geometry`` and ``photometric_device``
do.

Tolerances: the warp's labels and query masks exactly; its image within
1e-3 on the 0-255 scale (the same f32 taps, other summation orders of the
products). The photometric passes within 1e-3 on 0-255, except where a
``round`` (the greyscale, the contrast's grey mean) sits on a .5 tie that
the two frameworks' last bits break apart: such a pixel may differ by one
grey level, and they must be fewer than 1e-4 of all pixels. A whole padded
batch: the valid counts per row, the (coordinate, label) sets of the valid
picks and the overflow exactly; x within 1e-4 on the normalised scale
outside the counted ties (1e-4 of the pixels). The port's own sampler:
each draw in its range, each gate's rate within 4 standard errors of its
probability over 4000 samples.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelpick_tpu.data import device_pipeline as jdp
from pixelpick_tpu_torch.data import device_pipeline as pdp
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

JITTER = (0.8, 0.8, 0.8, 0.2)
GEO = {"random_scale": True, "crop": True, "random_hflip": True}
PHOTO = {"random_color_jitter": True, "random_grayscale": True,
         "random_gaussian_blur": True}
X_TOL = 1e-3      # on the 0-255 scale
XN_TOL = 1e-4     # on the normalised scale
TIE_SHARE = 1e-4  # of all pixels


def jax_draws(keys, src_hw, crop_hw, geo=GEO, jitter=JITTER):
    """The port's draw dict holding what JAX's ``batch_impl`` draws from
    ``keys``, one per sample: ``kg, kp = split(key)``; the geometry from
    ``kg`` (``_sample_geometry``), the photometric draws from ``kp``
    (``photo_draws``)."""
    geom = {k: [] for k in ("rs", "top", "left", "flip")}
    kps = []
    for key in keys:
        kg, kp = jax.random.split(key)
        rs, _, _, top, left, flip = jdp._sample_geometry(kg, src_hw, crop_hw,
                                                         geo)
        for k, v in zip(geom, (rs, top, left, flip)):
            geom[k].append(np.asarray(v))
        kps.append(kp)
    return {**{k: torch.from_numpy(np.stack(v)) for k, v in geom.items()},
            **photo_draws(kps, jitter)}


def photo_draws(keys, jitter=JITTER):
    """The draws ``photometric_device(x, key)`` makes, per key: it splits
    ``key`` into the nine keys kb, kc, ks, kh, kap, kg, kbl, kbs, kord."""
    bf, cf, sf, hf = jitter
    u = jax.random.uniform
    out = {k: [] for k in ("jitter", "f_b", "f_c", "f_s", "f_h", "order",
                           "gray", "blur", "sigma")}
    for key in keys:
        kb, kc, ks, kh, kap, kgr, kbl, kbs, kord = jax.random.split(key, 9)
        vals = {"jitter": u(kap) < 0.8,
                "f_b": u(kb, minval=max(0, 1 - bf), maxval=1 + bf),
                "f_c": u(kc, minval=max(0, 1 - cf), maxval=1 + cf),
                "f_s": u(ks, minval=max(0, 1 - sf), maxval=1 + sf),
                "f_h": u(kh, minval=-hf, maxval=hf),
                "order": jax.random.permutation(kord, 4),
                "gray": u(kgr) < 0.2, "blur": u(kbl) < 0.5,
                "sigma": u(kbs, minval=0.1, maxval=2.0)}
        for k, v in vals.items():
            out[k].append(np.asarray(v))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def torch_draws(**cols):
    """A draw dict from NumPy columns (the geometry tests' hand-set
    draws)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in cols.items()}


def images(rng, n, h, w):
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


# ------------------------------- warp -------------------------------

WARP_CASES = {
    # name: (rs, top, left, flip), source 24x32, crop 16x20 (or the crop
    # of the pad case)
    "identity": (1.0, 0, 0, False),
    "flip": (1.0, 4, 6, True),
    "rs0.5": (0.5, 0, 0, False),      # 12x16 scaled: pad region
    "rs0.7": (0.7, 1, 2, True),
    "rs1.3": (1.3, 7, 11, False),
    "rs2.0": (2.0, 25, 40, True),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_matches_jax(case):
    rng = np.random.default_rng(sorted(WARP_CASES).index(case))
    n, h, w = 1, 24, 32
    crop = (h, w) if case == "identity" else (16, 20)
    rs, top, left, flip = WARP_CASES[case]
    x = images(rng, n, h, w)
    y = rng.integers(0, 12, (n, h, w)).astype(np.int32)
    q = rng.random((n, h, w)) < 0.2
    fill, ignore = (7.0, 8.0, 9.0), 11

    geom = (jnp.float32(rs), jnp.floor(h * jnp.float32(rs)).astype(jnp.int32),
            jnp.floor(w * jnp.float32(rs)).astype(jnp.int32),
            jnp.int32(top), jnp.int32(left), jnp.bool_(flip))
    xj, yj, qj = jdp.warp_sample(jnp.asarray(x[0]), jnp.asarray(y[0]),
                                 jnp.asarray(q[0]), crop, geom,
                                 mean_fill=fill, ignore_index=ignore)
    draws = torch_draws(rs=np.float32([rs]), top=[top], left=[left],
                        flip=[flip])
    xp, yp, qp = pdp.warp(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(q), draws, crop, mean_fill=fill,
                          ignore_index=ignore)
    np.testing.assert_array_equal(yp[0].numpy(), np.asarray(yj))
    np.testing.assert_array_equal(qp[0].numpy(), np.asarray(qj))
    np.testing.assert_allclose(xp[0].numpy(), np.asarray(xj), atol=X_TOL,
                               rtol=0)
    if case == "identity":
        np.testing.assert_array_equal(yp[0].numpy(), y[0])
        np.testing.assert_allclose(xp[0].numpy(), x[0], atol=X_TOL, rtol=0)
    if case == "rs0.5":  # outside the 12x16 scaled image: the fills
        assert (yp[0, 12:].numpy() == ignore).all() and not qp[0, 12:].any()
        np.testing.assert_array_equal(xp[0, 14, 18].numpy(), fill)


def test_warp_batch_matches_jax_samples():
    """A batch of 5 with JAX's sampled geometry, each row as JAX warps
    it alone."""
    rng = np.random.default_rng(9)
    n, h, w, crop = 5, 24, 32, (16, 20)
    x = images(rng, n, h, w)
    y = rng.integers(0, 12, (n, h, w)).astype(np.int32)
    q = rng.random((n, h, w)) < 0.2
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    draws = jax_draws(keys, (h, w), crop)
    xp, yp, qp = pdp.warp(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(q), draws, crop,
                          mean_fill=(1.0, 2.0, 3.0), ignore_index=11)
    for i, key in enumerate(keys):
        geom = jdp._sample_geometry(jax.random.split(key)[0], (h, w), crop,
                                    GEO)
        xj, yj, qj = jdp.warp_sample(jnp.asarray(x[i]), jnp.asarray(y[i]),
                                     jnp.asarray(q[i]), crop, geom,
                                     mean_fill=(1.0, 2.0, 3.0),
                                     ignore_index=11)
        np.testing.assert_array_equal(yp[i].numpy(), np.asarray(yj))
        np.testing.assert_array_equal(qp[i].numpy(), np.asarray(qj))
        np.testing.assert_allclose(xp[i].numpy(), np.asarray(xj), atol=X_TOL,
                                   rtol=0)


# ----------------------------- photometric -----------------------------

def held_with_ties(got, ref, tol):
    """(the number of pixels of (B, h, w, 3) off by more than ``tol``, the
    number of pixels, the largest error)."""
    err = np.abs(got - ref).max(-1)
    off = err > tol
    return int(off.sum()), off.size, float(err.max())


def gated_keys(n, gate, seed=0):
    """``n`` keys whose photometric ``gate`` key draws the op on: kap for
    the jitter (< 0.8), kg for the greyscale (< 0.2), kbl for the blur
    (< 0.5); each key is the ``key`` of ``photometric_device``."""
    slot, p = {"jitter": (4, 0.8), "gray": (5, 0.2), "blur": (6, 0.5)}[gate]
    keys, s = [], seed
    while len(keys) < n:
        k = jax.random.PRNGKey(s)
        if float(jax.random.uniform(jax.random.split(k, 9)[slot])) < p:
            keys.append(k)
        s += 1
    return keys


PHOTO_CASES = {
    "jitter": {"random_color_jitter": True},
    "gray": {"random_grayscale": True},
    "blur": {"random_gaussian_blur": True},
}


@pytest.mark.parametrize("case", sorted(PHOTO_CASES))
def test_photometric_op_matches_jax(case):
    """Each op forced on alone (the others disabled in both packages), on
    the same warped-looking input (non-integer values) for 6 samples."""
    rng = np.random.default_rng(11)
    n, h, w = 6, 24, 32
    x = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    x[0] = np.round(x[0])  # one integer image, as an identity warp gives
    enabled = {k: False for k in PHOTO}
    enabled.update(PHOTO_CASES[case])
    blur_k = 5
    keys = gated_keys(n, case)
    ref = np.stack([np.asarray(jdp.photometric_device(
        jnp.asarray(x[i]), k, blur_kernel=blur_k, enabled=enabled))
        for i, k in enumerate(keys)])
    # the photometric draws of key k are those of a batch key whose kp is
    # k: feed them directly
    draws = photo_draws(keys)
    got = pdp.photometric(torch.from_numpy(x), draws, blur_kernel=blur_k,
                          enabled=enabled).numpy()
    n_off, size, worst = held_with_ties(got, ref, X_TOL)
    assert worst <= 1.0 + X_TOL, worst
    assert n_off <= TIE_SHARE * size, (n_off, size)
    assert not np.array_equal(got, x)  # the op acted


def test_photometric_all_ops_match_jax():
    """All ops enabled, JAX's own gates, 8 samples of 16x24."""
    rng = np.random.default_rng(12)
    n, h, w = 8, 16, 24
    x = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    keys = [jax.random.PRNGKey(100 + i) for i in range(n)]
    ref = np.stack([np.asarray(jdp.photometric_device(
        jnp.asarray(x[i]), k, blur_kernel=3, enabled=PHOTO))
        for i, k in enumerate(keys)])
    got = pdp.photometric(torch.from_numpy(x), photo_draws(keys),
                          blur_kernel=3, enabled=PHOTO).numpy()
    n_off, size, worst = held_with_ties(got, ref, X_TOL)
    assert worst <= 1.0 + X_TOL and n_off <= TIE_SHARE * size, \
        (n_off, size, worst)



# ------------------------- sparse extraction -------------------------

def picks(coords, labels, valid):
    return {(int(c[0]), int(c[1]), int(lb))
            for c, lb, v in zip(coords, labels, valid) if v}


def test_sparse_coords_match_jax():
    """The same (coordinate, label) set per row as JAX's top-k, and the
    host extractor's order; with a starved k_max the same overflow."""
    from pixelpick_tpu_torch.data.base import extract_sparse_labels

    rng = np.random.default_rng(2)
    q = rng.random((3, 12, 16)) < 0.1
    q[2] = False  # a mask with no labelled pixel
    y = rng.integers(0, 12, (3, 12, 16)).astype(np.int32)  # 11 is void
    coords, labels, valid, over = pdp.sparse_coords(
        torch.from_numpy(q), torch.from_numpy(y), 11, 32)
    for i in range(3):
        jc, jl, jv, jo = jdp.sparse_coords_device(
            jnp.asarray(q[i]), jnp.asarray(y[i]), 11, 32)
        assert picks(coords[i], labels[i], valid[i]) \
            == picks(np.asarray(jc), np.asarray(jl), np.asarray(jv))
        assert int(over[i]) == int(jo) == 0
        hc, hl, hv = extract_sparse_labels(q[i], y[i], 11, 32)
        np.testing.assert_array_equal(coords[i].numpy()[hv], hc[hv])
        np.testing.assert_array_equal(valid[i].numpy(), hv)
    assert not valid[2].any()
    *_, over = pdp.sparse_coords(torch.from_numpy(q), torch.from_numpy(y),
                                 11, 2)
    for i in range(3):
        jo = jdp.sparse_coords_device(jnp.asarray(q[i]), jnp.asarray(y[i]),
                                      11, 2)[3]
        assert int(over[i]) == int(jo) == max(int(q[i].sum()) - 2, 0)


# --------------------------- whole batches ---------------------------

CROP = (32, 48)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The JAX and the port's dataset over one synthetic CamVid (8 images
    of 48x64), crop 32x48, and query masks on 10 % of the pixels."""
    from types import SimpleNamespace

    from pixelpick_tpu.data import get_dataset as jax_get_dataset
    from pixelpick_tpu_torch import config
    from pixelpick_tpu_torch.data.factory import get_dataset
    from tests.helpers import synthetic_args

    tmp = tmp_path_factory.mktemp("pipe")
    jargs = synthetic_args(tmp / "jax", n_pixels_by_us=5, max_budget=10,
                           device_augment=True)
    pargs = config.default_args(
        device="cpu", dir_dataset=jargs.dir_dataset,
        dir_checkpoints=str(tmp / "port"), n_pixels_by_us=5, max_budget=10,
        device_augment=True)
    os.makedirs(pargs.dir_checkpoints, exist_ok=True)
    jds, pds = jax_get_dataset(jargs), get_dataset(pargs)
    jds.crop_size = pds.crop_size = CROP
    masks = list(np.random.default_rng(3).random((8, 48, 64)) < 0.1)
    return SimpleNamespace(jds=jds, jargs=jargs, pds=pds, pargs=pargs,
                           masks=masks)


def pipeline_pair(ds, k_max):
    jpipe = jdp.DevicePipeline(ds.jds, ds.jargs, k_max=k_max)
    ppipe = pdp.DevicePipeline(ds.pds, ds.pargs, "cpu")
    ppipe.k_max = k_max
    for p in (jpipe, ppipe):
        p.set_queries(ds.masks)
        p.pad_multiple = 4
    return jpipe, ppipe


def test_sample_batch_matches_jax(datasets):
    """A remainder of 5 images padded to 8 (micro-batch 4) with duplicates
    of the last index, the same draws: the pad rows hold no valid pick
    and no overflow; every real row matches. With k_max starved to 4, the
    same overflow."""
    indices = np.array([3, 1, 6, 0, 7])
    rng = jax.random.PRNGKey(5)
    draws = jax_draws(jax.random.split(rng, 8), (48, 64), CROP)
    for k_max in (1200, 4):
        jpipe, ppipe = pipeline_pair(datasets, k_max)
        ref = jpipe.sample_batch(indices, rng)
        ppipe.draw = lambda n, generator: draws  # JAX's draws
        got = ppipe.sample_batch(indices, None)
        assert int(got["overflow"]) == int(ref["overflow"])
        if k_max == 4:
            assert int(got["overflow"]) > 0
            continue
        assert int(got["overflow"]) == 0
        assert got["n_real"] == ref["n_real"] == 5
        assert got["x"].shape == (8, *CROP, 3)
        assert got["x"].dtype == torch.float32
        np.testing.assert_array_equal(got["rows_real"].get(),
                                      got["valid"].numpy().any(1))
        assert not got["valid"][5:].any()
        jvalid = np.asarray(ref["valid"])
        np.testing.assert_array_equal(got["valid"].numpy().sum(1),
                                      jvalid.sum(1))
        for i in range(8):
            assert picks(got["coords"][i], got["labels"][i],
                         got["valid"][i]) \
                == picks(np.asarray(ref["coords"][i]),
                         np.asarray(ref["labels"][i]), jvalid[i])
        assert jvalid.sum() > 100  # the masks' picks survived the crops
        n_off, size, worst = held_with_ties(got["x"].numpy(),
                                            np.asarray(ref["x"]), XN_TOL)
        assert n_off <= TIE_SHARE * size, (n_off, size, worst)


def test_sampler_draws(datasets):
    """The port's own draws over 4000 samples: every draw in its range,
    offsets on [0, max(scaled, crop) - crop] reaching both ends, each order
    a permutation, each gate at its rate within 4 standard errors."""
    _, pipe = pipeline_pair(datasets, 100)
    n = 4000
    d = pipe.draw(n, torch.Generator().manual_seed(0))
    d2 = pipe.draw(n, torch.Generator().manual_seed(0))
    for k in d:
        assert torch.equal(d[k], d2[k]), k  # a function of the seed
    rs = d["rs"].numpy()
    assert rs.min() >= 0.5 and rs.max() < 2.0
    for key, src, crop in (("top", 48, CROP[0]), ("left", 64, CROP[1])):
        room = np.maximum(np.floor(src * rs).astype(int), crop) - crop
        off = d[key].numpy()
        assert (off >= 0).all() and (off <= room).all()
        assert (off == room).any() and (off[room > 0] == 0).any()
    for key, (lo, hi) in {"f_b": (0.2, 1.8), "f_c": (0.2, 1.8),
                          "f_s": (0.2, 1.8), "f_h": (-0.2, 0.2),
                          "sigma": (0.1, 2.0)}.items():
        v = d[key].numpy()
        assert v.min() >= lo and v.max() < hi, key
    assert (np.sort(d["order"].numpy(), 1) == np.arange(4)).all()
    for key, p in {"flip": 0.5, "jitter": 0.8, "gray": 0.2,
                   "blur": 0.5}.items():
        rate = d[key].float().mean().item()
        assert abs(rate - p) <= 4 * np.sqrt(p * (1 - p) / n), (key, rate)


# ------------------------------ the driver ------------------------------

def round_args(tmp_path, name, batch_size, *flags, n_epochs=2):
    """``main_al``'s arguments over a 10-image custom CamVid at 48x64 (the
    batch size and epochs set by the dataset config, as in both
    packages)."""
    import yaml

    from pixelpick_tpu_torch.config import Arguments
    from torch_helpers import custom_camvid

    cfg = custom_camvid(tmp_path / name, n_train=10)
    c = yaml.safe_load(cfg.read_text())
    c.update(batch_size=batch_size, n_epochs=n_epochs)
    cfg.write_text(yaml.safe_dump(c))
    return Arguments().parse_args([
        "-pdc", str(cfg), "--dir_checkpoints", str(tmp_path / name / "run"),
        "--device", "cpu", "--width_multiplier", "0.5", "--n_pixels_by_us",
        "4", "--max_budget", "4", "--top_n_percent", "0",
        "--pool_batch_size", "4", "--n_workers", "2", "--seed", "1",
        "--device_augment", *flags])


@pytest.mark.usefixtures("few_torch_threads")
@pytest.mark.parametrize("mode", ["bs4", "bs8_micro4"])
def test_device_augment_round(tmp_path, monkeypatch, mode):
    """One round of ``main_al --device_augment`` on the CPU, 2 epochs of 10
    images: at bs 4 (batches 4, 4, 2) every batch is an update; at bs 8 /
    micro 4 the remainder of 2 pads to 4 with duplicate rows. There the
    masks of all images but image 0 are emptied, and image 0 holds a grid
    of picks every 4 pixels that every crop keeps: the one micro-batch per
    epoch that holds image 0 updates, the two labels-free ones are no-ops
    (no optimizer step; NaN losses the epoch mean skips). The train PNGs,
    the next round's picks and finite losses are written."""
    import pickle as pkl

    from pixelpick_tpu_torch.active import codec, driver

    opts = []
    make_optimizer = driver.make_optimizer

    def kept(*a, **k):
        opts.append(make_optimizer(*a, **k))
        return opts[-1]

    monkeypatch.setattr(driver, "make_optimizer", kept)
    micro = mode == "bs8_micro4"
    args = round_args(tmp_path, mode, 8 if micro else 4,
                      *(["--micro_batch_size", "4"] if micro else []))
    al = driver.ALModel(args)
    try:
        assert al.device_pipe is not None
        assert al.device_pipe.pad_multiple == (4 if micro else 1)
        if micro:
            grid = np.zeros((48, 64), bool)
            grid[2::4, 2::4] = True
            queries = [grid] + [np.zeros_like(grid)] * 9
            al.dataset.queries = al.dataset_query.queries = queries
            al.dataset.n_pixels_total = al.dataset_query.n_pixels_total = \
                int(grid.sum())
            al.device_pipe.k_max = 4 * int(grid.sum())
        al()
    finally:
        al.close()
    assert opts[0].step_count == (2 if micro else 2 * 3)
    stage = tmp_path / mode / "run" / "0_query"
    for f in ("1_train.png", "2_train.png", "1_val.png", "log_train.txt",
              "best_miou_model.ckpt"):
        assert (stage / f).is_file(), f
    rows = (stage / "log_train.txt").read_text().split()[1:]
    assert len(rows) == 2
    assert all(np.isfinite(float(r.split(",")[3])) for r in rows)
    with open(stage.parent / "1_query" / "queries.pkl", "rb") as f:
        masks = codec.decode_queries(pkl.load(f))
    assert len(masks) == 10 and all(int(m.sum()) == 4 for m in masks)


@pytest.mark.usefixtures("few_torch_threads")
def test_labels_free_micro_batch_is_a_no_op(datasets):
    """A device megabatch of 8 real rows whose second micro-batch's crops
    hold no labelled pixel (its images' masks are empty): bit-equal to the
    first micro-batch's update alone, one optimizer step, NaN in the no-op
    slot, as JAX's scan keeps the prior state wholesale
    (``trainer.py:197-201``)."""
    from pixelpick_tpu_torch.engine import optim, trainer
    from pixelpick_tpu_torch.models.factory import get_model

    _, pipe = pipeline_pair(datasets, 400)
    masks = list(datasets.masks)
    for i in (4, 5, 6, 7):
        masks[i] = np.zeros_like(masks[i])
    pipe.set_queries(masks)
    batch = pipe.sample_batch(np.arange(8),
                              torch.Generator().manual_seed(3))
    assert list(batch["rows_real"].get()) == [True] * 4 + [False] * 4
    kw = dict(n_classes=11, mean=datasets.pargs.mean,
              std=datasets.pargs.std, normalize=False)
    args = datasets.pargs
    args.width_multiplier = 0.5

    def fresh():
        model = get_model(args, "cpu", seed=7).train()
        model.set_dropout_generator(torch.Generator().manual_seed(8))
        return model, optim.make_optimizer(args, model, 10)

    model, opt = fresh()
    losses, _ = trainer.make_microbatch_train_step(
        model, opt, micro_bs=4, **kw)(batch)
    ref_model, ref_opt = fresh()
    ref_loss, _ = trainer.make_train_step(ref_model, ref_opt, **kw)(
        {k: batch[k][:4] for k in trainer.SPARSE_KEYS})
    assert opt.step_count == ref_opt.step_count == 1
    assert torch.isnan(losses[1]) and torch.equal(losses[0], ref_loss)
    ref = ref_model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.usefixtures("few_torch_threads")
def test_device_augment_stage_resume(tmp_path):
    """A 4-epoch bs-8/micro-4 stage under ``--device_augment`` interrupted
    in epoch 3 (its epoch-2 snapshot on disk) and rerun ends bit-equal to
    the straight stage: each batch's draws are a function of (round seed,
    epoch, batch index)."""
    from pixelpick_tpu_torch.active.driver import ALModel

    def run(args, crash_at=None):
        al = ALModel(args)
        al.nth_query = 0
        if crash_at:
            train_epoch = al._train_epoch

            def crashing(epoch, step_fn):
                if epoch == crash_at:
                    raise KeyboardInterrupt
                return train_epoch(epoch, step_fn)

            al._train_epoch = crashing
        try:
            return al._run_stage("0_query").state_dict()
        finally:
            al.close()

    micro = ["--micro_batch_size", "4"]
    straight = run(round_args(tmp_path, "straight", 8, *micro, n_epochs=4))
    args = round_args(tmp_path, "resumed", 8, *micro,
                      "--stage_ckpt_interval", "2", n_epochs=4)
    with pytest.raises(KeyboardInterrupt):
        run(args, crash_at=3)
    assert os.path.isfile(f"{args.dir_checkpoints}/0_query/stage_state.ckpt")
    resumed = run(args)
    assert list(resumed) == list(straight)
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
