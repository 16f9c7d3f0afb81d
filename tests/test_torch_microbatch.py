"""The port's micro-batch train step (``--micro_batch_size``;
engine/trainer.py:make_microbatch_train_step, parallel/mesh.py, the
Loader's ``drop_unit`` and the driver's plumbing) against the JAX
package's (pixelpick_tpu/engine/trainer.py:136), at the same weights and
megabatches: the whole DeepLab at width 0.5, 48x64, micro-batches of 4.

Cases: a megabatch of 12 rows (three updates); a remainder of 11 rows
padded to 12 (the last micro-batch holds 3 real rows and 1 pad row, which
joins its BatchNorm moments in both packages; 12 rows, so that JAX
compiles one program for the file); and 12 rows whose third micro-batch
is all pad (a true no-op: no update, no step, no running statistic moves,
NaN in its loss slot).

As tests/test_torch_train_step.py, whose helpers this reuses: dropout off on
both sides, SGD, well-conditioned weights with the ReLU-kink margin checked
as a precondition. The JAX side runs unfused (``fused_ir=False``: fused =
unfused is held in tests/test_torch_fused_ir.py and
tests/test_torch_train_step.py), the port's side with ``fused_ir`` off and
on (the kernels' plain versions on the CPU).

Tolerances: each update's loss 1e-5 relative; the summed confusion matrix
exactly; the parameters after the megabatch within 1e-4 of their largest
move plus 1e-6 of their largest |value|; the running statistics 1e-4 of
their largest |value| (at least 1); the update and forward counts exactly.
The driver-level test is the port against itself: a bs-8/micro-4 stage
runs the same per-update program as a bs-4 stage, so their epoch losses
agree to 1e-6 relative.
"""

import os

import flax.linen
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from pixelpick_tpu.data.loader import Loader as JaxLoader
from pixelpick_tpu.engine import optim as jax_optim
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu.parallel.mesh import pad_batch_to_devices as jax_pad
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.data.loader import Loader
from pixelpick_tpu_torch.engine import optim, trainer
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.parallel.mesh import pad_batch_to_devices
from tests.helpers import make_synthetic_camvid
from torch_helpers import (
    N_CLASSES, jax_deeplab_variables, record_kink_margins, sgd_args,
    sparse_batches, well_conditioned,
)
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

WIDTH, MICRO, ITERS, IGNORE = 0.5, 4, 5, 11
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _megabatch(case):
    """(host batch, n_real) of a case, padded as the driver pads it."""
    rows = sparse_batches(3, seed=21)
    batch = {k: np.concatenate([b[k] for b in rows]) for k in rows[0]}
    if case == "remainder":
        return pad_batch_to_devices({k: v[:11] for k, v in batch.items()},
                                    pad_label=IGNORE, target_rows=12)
    if case == "all_pad":
        batch["valid"][8:] = False
    return batch, 12


@pytest.fixture(scope="module")
def weights():
    params, stats = jax_deeplab_variables(N_CLASSES, WIDTH, (48, 64), seed=2)
    return well_conditioned(params, np.random.default_rng(102)), stats


@pytest.fixture(scope="module")
def jax_results(weights):
    """The JAX megabatch step on each case: (losses, hist, step, final
    state dict in the port's names)."""
    params, stats = weights
    orig = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        model = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH)
        tx = jax_optim.make_optimizer(sgd_args(), params, ITERS)
        step = jax_trainer.make_microbatch_train_step(
            model, tx, micro_bs=MICRO, n_classes=N_CLASSES, mean=MEAN,
            std=STD, donate=False)
        out = {}
        for case in ("full", "remainder", "all_pad"):
            batch, _ = _megabatch(case)
            state = jax_trainer.create_train_state(
                jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, stats), tx)
            state, losses, hist = step(state, jax.tree.map(jnp.asarray, batch),
                                       jax.random.PRNGKey(0))
            out[case] = (np.asarray(losses), np.asarray(hist),
                         int(state.step), state_dict_from_jax(
                             jax.tree.map(np.asarray, state.params),
                             jax.tree.map(np.asarray, state.batch_stats)))
    finally:
        flax.linen.Dropout.__call__ = orig
    return out


def _port(params, stats, fused):
    model = DeepLab(N_CLASSES, width_mult=WIDTH, fused_ir=fused)
    model.load_state_dict(state_dict_from_jax(params, stats))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    model = model.to(memory_format=torch.channels_last)
    args = default_args(device="cpu")
    args.optimizer_type = "SGD"
    args.optimizer_params = sgd_args().optimizer_params
    opt = optim.make_optimizer(args, model, ITERS)
    step = trainer.make_microbatch_train_step(
        model, opt, micro_bs=MICRO, n_classes=N_CLASSES, mean=MEAN, std=STD)
    return model, opt, step


@pytest.mark.parametrize("case", ["full", "remainder", "all_pad"])
@pytest.mark.parametrize("fused", [False, True])
def test_microbatch_step_matches_jax(weights, jax_results, case, fused,
                                     monkeypatch):
    params, stats = weights
    losses_j, hist_j, step_j, final_j = jax_results[case]
    model, opt, step = _port(params, stats, fused)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batch, _ = _megabatch(case)
    margins = record_kink_margins(monkeypatch)
    losses, hist = step(batch)
    assert min(margins) > 1e-4, "a ReLU input is near a kink"

    n_updates = 2 if case == "all_pad" else 3
    assert opt.step_count == step_j == n_updates
    assert losses.shape == losses_j.shape
    real = np.isfinite(losses_j)
    np.testing.assert_array_equal(np.isfinite(losses.numpy()), real)
    np.testing.assert_allclose(losses.numpy()[real], losses_j[real],
                               rtol=1e-5)
    np.testing.assert_array_equal(hist.numpy(), hist_j)

    sd = model.state_dict()
    for k, ref in final_j.items():
        got = sd[k].float()
        if k.endswith("num_batches_tracked"):
            assert int(got) == n_updates, k
            continue
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(ref.abs().max()), 1.0)
        else:
            moved = float((ref - start[k]).abs().max())
            tol = 1e-4 * moved + 1e-6 * float(ref.abs().max())
        err = float((got - ref).abs().max())
        assert err <= tol, f"{k}: {err} > {tol}"

    if case == "all_pad":
        # bit-equal to the two real micro-batches alone: the pad one moved
        # nothing, the optimizer's moments and count included
        model2, opt2, step2 = _port(params, stats, fused)
        step2({k: v[:8] for k, v in batch.items()})
        for k, v in model2.state_dict().items():
            assert torch.equal(v, sd[k]), k
        assert opt2.step_count == opt.step_count
        for a, b in zip(opt.state, opt2.state):
            for name in a:
                assert all(torch.equal(x, y) for x, y in zip(a[name], b[name]))


def test_pad_matches_jax():
    """The remainder padding: duplicates of the last row with every
    masking key overridden, as the JAX function pads them."""
    rng = np.random.default_rng(3)
    batch = {"x": rng.integers(0, 255, (3, 4, 5, 3), dtype=np.uint8),
             "valid": rng.random((3, 6)) < 0.5,
             "y": rng.integers(0, 11, (3, 4, 5)).astype(np.int32),
             "excluded": rng.random((3, 4, 5)) < 0.5,
             "index": np.arange(3, dtype=np.int32)}
    got, n = pad_batch_to_devices(batch, pad_label=IGNORE, target_rows=8)
    ref, n_ref = jax_pad(batch, None, pad_label=IGNORE, target_rows=8)
    assert n == n_ref == 3
    for k in batch:
        np.testing.assert_array_equal(got[k], ref[k])
    assert not got["valid"][3:].any() and (got["index"][3:] == -1).all()
    same, n = pad_batch_to_devices(batch, pad_label=IGNORE, target_rows=3)
    assert same is batch and n == 3


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,bs,unit", [(13, 8, 4), (13, 4, None),
                                       (12, 8, 4), (367, 48, 4)])
def test_drop_unit_plan_matches_jax(n, bs, unit):
    """The drop-last rule at the update size: 13 images at bs 8 / micro 4
    drop one (13 % 4 == 1), as the reference's bs-4 run does; the plans
    are the JAX Loader's, batch by batch."""
    with Loader(_Sized(n), bs, mode="train", shuffle=True, seed=3,
                drop_unit=unit) as ours:
        ref = JaxLoader(_Sized(n), bs, mode="train", shuffle=True, seed=3,
                        drop_unit=unit)
        try:
            assert ours.drop_last == ref.drop_last
            for epoch in (0, 1):
                a, b = ours.batch_index_plan(epoch), ref.batch_index_plan(epoch)
                assert [x.tolist() for x in a] == [x.tolist() for x in b]
        finally:
            ref.close()


@pytest.fixture(scope="module")
def dataset_cfg(tmp_path_factory):
    """An 8-image and a 13-image synthetic CamVid layout at 48x64."""
    tmp = tmp_path_factory.mktemp("micro")
    roots = {}
    for n in (8, 13):
        root = make_synthetic_camvid(str(tmp / f"ds{n}"), n_train=n, n_test=2)
        os.rename(f"{root}/test", f"{root}/val")
        os.rename(f"{root}/testannot", f"{root}/valannot")
        roots[n] = root
    return tmp, roots


def _al_model(tmp, root, name, batch_size, *flags):
    """The port's driver through its argument path, on a custom-dataset
    config (the batch size is set by the config, as in both packages),
    augmentation off."""
    from pixelpick_tpu_torch.active.driver import ALModel
    from pixelpick_tpu_torch.config import Arguments

    cfg = dict(dataset_name="custom", dir_dataset=root, batch_size=batch_size,
               ignore_index=IGNORE, n_classes=N_CLASSES, n_epochs=2,
               mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25],
               optimizer_type="Adam", lr_scheduler_type="MultiStepLR",
               optimizer_params={"lr": 5e-4, "betas": [0.9, 0.999],
                                 "weight_decay": 2e-4, "eps": 1e-7})
    (tmp / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
    args = Arguments().parse_args([
        "-pdc", str(tmp / f"{name}.yaml"), "--dir_checkpoints",
        str(tmp / name), "--device", "cpu", "--width_multiplier", "0.5",
        "--n_pixels_by_us", "4", "--max_budget", "4", "--n_workers", "2",
        "--use_aug", "False", *flags])
    return ALModel(args)


def test_iters_per_epoch_and_divisor(dataset_cfg):
    """13 images at bs 8 / micro 4: the last shuffled image drops (13 % 4
    == 1) and the schedule counts 2 + 1 updates, the reference's bs-4
    count; a micro size that does not divide the batch raises the JAX
    message; in the fully supervised mode the flag is inert."""
    tmp, roots = dataset_cfg
    al = _al_model(tmp, roots[13], "ipe", 8, "--micro_batch_size", "4")
    try:
        assert al.loader.drop_unit == 4 and al.loader.drop_last
        assert [len(ix) for ix in al.loader.batch_index_plan(0)] == [8, 4]
        assert al._iters_per_epoch() == 3
    finally:
        al.close()
    with pytest.raises(ValueError, match="must divide"):
        _al_model(tmp, roots[13], "div", 8, "--micro_batch_size", "5")
    al = _al_model(tmp, roots[13], "fs", 8, "--micro_batch_size", "5",
                   "--n_pixels_by_us", "0")
    try:
        assert al._micro_bs() == 0 and al._iters_per_epoch() == 2
    finally:
        al.close()


def test_microbatch_stage_tracks_bs4_stage(dataset_cfg):
    """A bs-8/micro-4 stage against a bs-4 stage, 2 epochs on 8 images, at
    the same round seed: the same shuffled partitions, dropout draws and
    per-update programs, so the epoch losses agree to 1e-6 relative."""
    tmp, roots = dataset_cfg

    def run(name, *flags):
        al = _al_model(tmp, roots[8], name, *flags)
        try:
            al.nth_query = 0
            al._run_stage("0_query")
        finally:
            al.close()
        rows = (tmp / name / "0_query" / "log_train.txt").read_text().split()
        return [float(r.split(",")[3]) for r in rows[1:]]

    ref = run("bs4", 4)
    got = run("mega", 8, "--micro_batch_size", "4")
    assert len(got) == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
