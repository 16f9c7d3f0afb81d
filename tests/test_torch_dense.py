"""The port's fully supervised mode (``--n_pixels_by_us 0``;
engine/trainer.py:make_dense_train_step, data/base.py:train_sample with
``fully_sup``, the Loader's ``train_dense`` mode and the driver's
``fully_sup`` stage) against the JAX package's.

The dense step: the whole DeepLab at width 0.5, 48x64, batch 4, one update
at the same weights and batch, against ``make_dense_train_step``
(pixelpick_tpu/engine/trainer.py:229). The JAX step's gradients are read
through an optax transformation that keeps them in its state and applies
none; the port's are the parameters' ``.grad`` after its step. As in
tests/test_torch_train_step.py (whose helpers this reuses): dropout off on
both sides, well-conditioned weights, the ReLU-kink margin checked as a
precondition; the JAX side unfused, the port with ``fused_ir`` off and on.
Tolerances: the loss 1e-5 relative; the full-resolution confusion matrix
exactly; every parameter gradient within 3e-4 of its own largest |value|
plus 3e-6 of the largest |gradient|. That is three times the sparse step's
limit: the dense loss sums 3,072 pixels per image where the sparse one
reads 12 picks, and the two frameworks' convolutions sum in other orders.
Measured on the CPU at these weights, the unfused port's worst leaf lies at
1.16e-4 of its own scale with a dozen leaves between 0.5e-4 and 1e-4: the
spread of rounding, not one leaf off (a 5% fault in a gradient is 170 times
the limit).

The ``train_dense`` loader: every batch of x and y equal exactly to the
JAX Loader's at the same seed and epochs, augmentation on.
"""

import contextlib
import io
import os

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import yaml

from pixelpick_tpu.config import default_args as jax_default_args
from pixelpick_tpu.data.factory import get_dataset as jax_get_dataset
from pixelpick_tpu.data.loader import Loader as JaxLoader
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data.factory import get_dataset
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine import optim, trainer
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from tests.helpers import make_synthetic_camvid
from torch_helpers import (
    HW, N_CLASSES, jax_deeplab_variables, record_kink_margins, sgd_args,
    sparse_batches, well_conditioned,
)
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

WIDTH, IGNORE = 0.5, 11
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _dense_batch():
    """Mosaic images and a dense label map of 8x8-pixel tiles, a tenth of
    them void."""
    rng = np.random.default_rng(31)
    x = sparse_batches(1, seed=30)[0]["x"]
    tiles = rng.integers(0, N_CLASSES, (len(x), HW[0] // 8, HW[1] // 8))
    tiles[rng.random(tiles.shape) < 0.1] = IGNORE
    y = np.kron(tiles, np.ones((1, 8, 8), np.int64)).astype(np.int32)
    return {"x": x, "y": y}


def _keep_grads():
    """An optax transformation that applies no update and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_step():
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=2)
    params = well_conditioned(params, np.random.default_rng(102))
    batch = _dense_batch()
    orig = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        tx = _keep_grads()
        step = jax_trainer.make_dense_train_step(
            JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH), tx,
            n_classes=N_CLASSES, ignore_index=IGNORE, mean=MEAN, std=STD,
            donate=False)
        state = jax_trainer.create_train_state(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats), tx)
        state, loss, hist = step(state, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))
        grads = state_dict_from_jax(jax.tree.map(np.asarray, state.opt_state),
                                    jax.tree.map(np.asarray, stats))
    finally:
        flax.linen.Dropout.__call__ = orig
    return params, stats, batch, float(loss), np.asarray(hist), grads


@pytest.mark.parametrize("fused", [False, True])
def test_dense_step_matches_jax(jax_step, fused, monkeypatch):
    params, stats, batch, loss_j, hist_j, grads_j = jax_step
    model = DeepLab(N_CLASSES, width_mult=WIDTH, fused_ir=fused)
    model.load_state_dict(state_dict_from_jax(params, stats))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    model = model.to(memory_format=torch.channels_last)
    args = default_args(device="cpu")
    args.optimizer_type = "SGD"
    args.optimizer_params = sgd_args().optimizer_params
    step = trainer.make_dense_train_step(
        model, optim.make_optimizer(args, model, 5), n_classes=N_CLASSES,
        ignore_index=IGNORE, mean=MEAN, std=STD)
    margins = record_kink_margins(monkeypatch)
    loss, hist = step(trainer.batch_to_device(batch, "cpu"))
    assert min(margins) > 1e-4, "a ReLU input is near a kink"
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
    np.testing.assert_array_equal(hist.numpy(), hist_j)
    valid = (batch["y"] != IGNORE).sum()
    assert hist.sum() == valid  # the full resolution, void dropped
    grads = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(float(grads_j[n].abs().max()) for n in grads)
    for n, g in grads.items():
        ref = grads_j[n]
        err = float((g.float() - ref).abs().max())
        tol = 3e-4 * float(ref.abs().max()) + 3e-6 * gmax
        assert err <= tol, f"grad {n}: {err} > {tol}"


def test_train_dense_batches_equal_the_jax_loaders(tmp_path):
    """9 images at batch 4 (the drop-last rule fires), crop 40x56,
    augmentation on: x and the dense y of every batch equal the JAX
    Loader's, epochs 1 and 2."""
    root = make_synthetic_camvid(str(tmp_path / "camvid"), n_train=9,
                                 n_test=2)
    common = dict(dir_dataset=root, n_pixels_by_us=0, batch_size=4, seed=3)
    jd = jax_get_dataset(jax_default_args(
        write_files=False, dir_checkpoints=str(tmp_path / "jax"), **common))
    pd = get_dataset(default_args(
        write_files=False, dir_checkpoints=str(tmp_path / "port"),
        device="cpu", **common))
    assert pd.queries is None
    jd.crop_size = pd.crop_size = (40, 56)
    jl = JaxLoader(jd, 4, mode="train_dense", shuffle=True, n_workers=2,
                   seed=3)
    pl = Loader(pd, 4, mode="train_dense", shuffle=True, n_workers=2, seed=3)
    try:
        assert len(pl) == len(jl) == 2 and pl.drop_last and jl.drop_last
        for epoch in (1, 2):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            n = 0
            for jb, pb in zip(jl, pl):
                assert set(pb) == {"x", "y"}
                for k in pb:
                    np.testing.assert_array_equal(pb[k], np.asarray(jb[k]),
                                                  err_msg=f"{k} {epoch}")
                assert pb["y"].shape[1:] == (40, 56)
                n += 1
            assert n == 2
    finally:
        jl.close()
        pl.close()


def test_fully_supervised_stage(tmp_path):
    """``main_al --n_pixels_by_us 0``: one ``fully_sup`` stage with the
    dense step and no query (tests/test_e2e_variants.py:78-88), finite
    losses, no labelled-pixel line."""
    from pixelpick_tpu_torch.cli.main_al import main

    root = make_synthetic_camvid(str(tmp_path / "ds"), n_train=8, n_test=2)
    os.rename(f"{root}/test", f"{root}/val")
    os.rename(f"{root}/testannot", f"{root}/valannot")
    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=4,
               ignore_index=IGNORE, n_classes=N_CLASSES, n_epochs=1,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp_path / "custom.yaml").write_text(yaml.safe_dump(cfg))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        al = main(["-pdc", str(tmp_path / "custom.yaml"), "--dir_checkpoints",
                   str(tmp_path / "ckpt"), "--device", "cpu",
                   "--width_multiplier", "0.5", "--n_pixels_by_us", "0",
                   "--n_workers", "2", "--fused_ir"])
    d = tmp_path / "ckpt" / "fully_sup"
    for f in ("best_miou_model.ckpt", "log_train.txt", "log_val.txt",
              "timing.json", "1_train.png", "1_val.png"):
        assert (d / f).is_file(), f
    rows = (d / "log_train.txt").read_text().split()[1:]
    assert len(rows) == 1
    assert all(np.isfinite(float(r.split(",")[3])) for r in rows)
    assert not (tmp_path / "ckpt" / "0_query").exists()
    assert "labelled pixels" not in out.getvalue()
    assert al.loader.mode == "train_dense"
