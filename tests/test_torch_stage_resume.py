"""Mid-stage snapshots (``--stage_ckpt_interval``) and the campaign
fast-forward (``--resume_campaign``) of the port's driver
(``pixelpick_tpu_torch/active/driver.py``), the counterpart of
tests/test_stage_resume.py, on the CPU at width 0.5, 48x64.

A 4-epoch stage interrupted in epoch 3 (its epoch-2 snapshot on disk) and
rerun by a new driver over the same directory ends with the parameters and
BatchNorm statistics of a straight 4-epoch run, bit for bit, dropout on:
the snapshot carries the optimizer's moments and step count and the
dropout generator's state, and the loader's shuffle and augmentation are
functions of (seed, epoch, index). The logs hold epochs 1-4 once each, and
the snapshot is gone. A finished campaign rerun with ``--resume_campaign``
trains nothing, labels the same pixels and leaves its logs untouched.

A snapshot of the JAX package (``pixelpick_tpu.engine.checkpoint.
save_stage_state``) resumes in the port, under Adam and under SGD: the JAX
``TrainState`` of a small DeepLab (width 0.5, 48x64) after three updates
(seeded random gradients, which give every moment a value) loads into the
port's model and optimizer with the weights, the BatchNorm statistics and
the moments bit-equal to JAX's, in both directions of the mapping, and the
step count 3. One more update on the same sparse batch from each side,
with the same dropout masks put into both models' dropout layers, then
agrees: every parameter within 1e-4 of its own update's largest |move| plus
1e-6 of its largest |value| (the bound and the well-conditioned weights of
tests/test_torch_train_step.py, which explains them), the running
statistics within 1e-4 of their largest |value| (at least 1).
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelpick_tpu.engine import checkpoint as jax_checkpoint
from pixelpick_tpu.engine import optim as jax_optim
from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu_torch.active.driver import ALModel
from pixelpick_tpu_torch.config import default_args
from pixelpick_tpu_torch.engine import checkpoint, optim, trainer
from pixelpick_tpu_torch.engine.flax_msgpack import flatten
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import (
    jax_tree_from_state_dict, state_dict_from_jax,
)
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import init_model
from torch_helpers import (
    N_CLASSES, custom_camvid, randomise_bn, sparse_batches, well_conditioned,
)
from torch_helpers import few_torch_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def make_args(tmp_path, sub, **over):
    return default_args(
        p_dataset_config=str(custom_camvid(tmp_path / sub)), device="cpu",
        dir_checkpoints=str(tmp_path / sub / "run"), width_multiplier=0.5,
        n_pixels_by_us=4, n_workers=2, seed=0, **over)


def rows(path):
    with open(path) as f:
        return f.read().strip().splitlines()


def test_stage_resume_reproduces_uninterrupted_run(tmp_path):
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

    straight = run(make_args(tmp_path, "straight", n_epochs=4,
                             max_budget=4))
    args = make_args(tmp_path, "resumed", n_epochs=4, max_budget=4,
                     stage_ckpt_interval=2)
    with pytest.raises(KeyboardInterrupt):
        run(args, crash_at=3)
    stage = f"{args.dir_checkpoints}/0_query"
    snap = f"{stage}/stage_state.ckpt"
    assert os.path.isfile(snap)
    assert [r.split(",")[0] for r in rows(f"{stage}/log_train.txt")] \
        == ["epoch", "1", "2"]

    resumed = run(args)
    assert not os.path.exists(snap)
    for log in ("log_train.txt", "log_val.txt"):
        assert [r.split(",")[0] for r in rows(f"{stage}/{log}")] \
            == ["epoch", "1", "2", "3", "4"]
    assert list(resumed) == list(straight)
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
    assert os.path.isfile(f"{stage}/best_miou_model.ckpt")


def test_resume_campaign_fast_forwards_completed_rounds(tmp_path):
    args = make_args(tmp_path, "campaign", n_epochs=1, max_budget=8,
                     top_n_percent=0.0, pool_batch_size=4)
    al = ALModel(args)
    al()
    al.close()
    n_px = al.dataset.n_pixels_total
    assert n_px == 3 * 4 * 8
    logs = [f"{args.dir_checkpoints}/{s}_query/{f}" for s in (0, 1)
            for f in ("log_train.txt", "log_val.txt", "best_miou_model.ckpt")]
    mtimes = [os.path.getmtime(p) for p in logs]

    args.resume_campaign = True
    al = ALModel(args)
    al._run_stage = None  # no stage may train
    al()
    al.close()
    assert al.dataset.n_pixels_total == n_px
    assert [os.path.getmtime(p) for p in logs] == mtimes


WIDTH, ITERS = 0.5, 10
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)


def _opt_args(opt_type):
    args = default_args(device="cpu")
    args.optimizer_type = opt_type
    args.optimizer_params = {"lr": 5e-4, "betas": (0.9, 0.999),
                             "weight_decay": 2e-4, "eps": 1e-7,
                             "momentum": 0.9}
    return args


N_DROPOUTS = 3  # ASPP's and the head's two, in call order
MASKS = []


def _jax_dropout(self, inputs, deterministic=None, rng=None):
    """flax's ``Dropout`` with the mask of its place in the call order,
    seeded by that place (a trace appends the model's masks again)."""
    det = flax.linen.module.merge_param("deterministic", self.deterministic,
                                        deterministic)
    if det or self.rate == 0:
        return inputs
    mask = np.random.default_rng(len(MASKS) % N_DROPOUTS).random(
        inputs.shape) >= self.rate
    MASKS.append((self.rate, mask))
    return jnp.where(mask, inputs / (1.0 - self.rate), 0.0)


@pytest.fixture(scope="module")
def jax_grad_fn():
    """The JAX loss gradient of the small DeepLab, traced with the dropout
    layers applying the masks of ``MASKS``."""
    model = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH)
    loss_fn = jax_trainer._sparse_loss_fn(
        model, n_classes=N_CLASSES, mean=MEAN, std=STD, normalize=True,
        gather_impl="matmul")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _jax_dropout)
        yield jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_dropouts(model):
    """Each active dropout of the port takes the next of ``MASKS``, from
    NHWC to the layout it is given."""
    calls = []

    def forward(self, x, active=None):
        if not (self.training if active is None else active) or self.p == 0:
            return x
        rate, mask = MASKS[len(calls) % N_DROPOUTS]
        calls.append(rate)
        assert rate == self.p
        m = torch.from_numpy(mask)
        if tuple(m.shape) != tuple(x.shape):
            m = m.permute(0, 3, 1, 2)
        return torch.where(m, x / (1.0 - self.p), torch.zeros_like(x))

    for mod in model.modules():
        if isinstance(mod, layers.Dropout):
            mod.forward = forward.__get__(mod)
    return calls


@pytest.mark.parametrize("opt_type", ["Adam", "SGD"])
def test_jax_stage_snapshot_resumes(tmp_path, opt_type, jax_grad_fn):
    rng = np.random.default_rng(11)
    params, stats, _ = jax_tree_from_state_dict(
        init_model(DeepLab(N_CLASSES, width_mult=WIDTH), 3).state_dict())
    params = well_conditioned(params, rng)
    stats = randomise_bn(stats, rng)
    args = _opt_args(opt_type)
    tx = jax_optim.make_optimizer(args, params, ITERS)
    state = jax_trainer.create_train_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx)

    @jax.jit
    def update(state, grads):
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params,
                                                        updates),
                             opt_state=opt_state, step=state.step + 1)

    for i in range(3):
        g_rng = np.random.default_rng(100 + i)
        grads = jax.tree.map(lambda p: jnp.asarray(
            1e-2 * g_rng.standard_normal(p.shape).astype(np.float32)),
            state.params)
        state = update(state, grads)
    path = str(tmp_path / "0_query" / "stage_state.ckpt")
    jax_checkpoint.save_stage_state(path, state, 2, 0.375)

    model = DeepLab(N_CLASSES, width_mult=WIDTH).to(
        memory_format=torch.channels_last)
    opt = optim.make_optimizer(args, model, ITERS)
    gen = torch.Generator()
    epoch, best = checkpoint.load_stage_state(path, model, opt, gen, seed=5)
    assert (epoch, best) == (2, 0.375) and opt.step_count == 3
    assert gen.initial_seed() == checkpoint.jax_resume_seed(5, 2)
    host = jax.device_get(state)
    want = state_dict_from_jax(host.params, host.batch_stats)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # the moments, both ways: the port's state in JAX's layout is JAX's
    import flax.serialization as ser

    opt_state, step = optim.optimizer_state_to_jax(opt, model)
    assert int(step) == 3
    ref = flatten(jax.tree.map(np.asarray,
                               ser.to_state_dict(host.opt_state)))
    got = flatten(opt_state)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.asarray(got[k]).dtype == ref[k].dtype, k
        assert np.array_equal(np.asarray(got[k]), ref[k]), k

    # and JAX reads the port's JAX-layout snapshot back to its own state
    back_path = str(tmp_path / "back" / "stage_state.ckpt")
    os.makedirs(os.path.dirname(back_path))
    checkpoint.save_jax_stage_state(back_path, model, opt, 2, 0.375)
    back, back_epoch, back_best = jax_checkpoint.load_stage_state(
        back_path, state)
    assert (back_epoch, back_best) == (2, 0.375)
    for a, b in zip(jax.tree.leaves(jax.device_get(back)),
                    jax.tree.leaves(host)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))

    # one more update on the same batch and the same dropout masks
    batch = sparse_batches(1, seed=4)[0]
    (_, (new_stats, _)), grads = jax_grad_fn(
        state.params, state.batch_stats, jax.tree.map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    after = jax.device_get(update(state.replace(batch_stats=new_stats),
                                  grads))
    assert [r for r, _ in MASKS[:N_DROPOUTS]] == [0.5, 0.5, 0.2]

    calls = _port_dropouts(model)
    step_fn = trainer.make_train_step(model, opt, n_classes=N_CLASSES,
                                      mean=MEAN, std=STD)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step_fn(trainer.batch_to_device(batch, "cpu"))
    assert calls == [0.5, 0.5, 0.2]
    want = state_dict_from_jax(after.params, after.batch_stats)
    for k, got in model.state_dict().items():
        ref = want[k]
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(ref.abs().max()), 1.0)
        else:
            moved = float((ref - before[k]).abs().max())
            tol = 1e-4 * moved + 1e-6 * float(ref.abs().max())
        err = float((got.float() - ref).abs().max())
        assert err <= tol, f"{k}: {err} > {tol}"


def test_driver_resumes_a_jax_layout_snapshot(tmp_path, monkeypatch):
    """The driver's resume (``_run_stage``) from a snapshot in the JAX
    package's layout, written from the port's own epoch-2 snapshot of an
    interrupted stage: the model and the optimizer after the load are the
    port snapshot's (the BatchNorm update count aside, which JAX does not
    keep), the stage finishes, its logs hold epochs 1-3 once each."""
    from pixelpick_tpu_torch.active import driver

    args = make_args(tmp_path, "jax_layout", n_epochs=3, max_budget=4,
                     stage_ckpt_interval=2)
    al = ALModel(args)
    al.nth_query = 0
    train_epoch = al._train_epoch

    def crashing(epoch, step_fn):
        if epoch == 3:
            raise KeyboardInterrupt
        return train_epoch(epoch, step_fn)

    al._train_epoch = crashing
    with pytest.raises(KeyboardInterrupt):
        al._run_stage("0_query")
    al.close()
    stage = f"{args.dir_checkpoints}/0_query"
    snap = f"{stage}/stage_state.ckpt"

    model = DeepLab(N_CLASSES, width_mult=WIDTH)
    opt = optim.make_optimizer(args, model, 2)
    checkpoint.load_stage_state(snap, model, opt, torch.Generator())
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = opt.state_dict()
    checkpoint.save_jax_stage_state(snap, model, opt, 2, 0.125)
    with open(snap, "rb") as f:
        assert f.read(1)[0] & 0xF0 == 0x80  # a msgpack map now

    got = {}
    load = driver.load_stage_state

    def recording(path, m, o, g, seed=None):
        out = load(path, m, o, g, seed=seed)
        got.update(model={k: v.clone() for k, v in m.state_dict().items()},
                   opt=o.state_dict(), seed=seed, out=out)
        return out

    monkeypatch.setattr(driver, "load_stage_state", recording)
    al = ALModel(args)
    al.nth_query = 0
    try:
        al._run_stage("0_query")
    finally:
        al.close()
    assert got["out"] == (2, 0.125) and got["seed"] == al.stage_seed
    for k, v in want_model.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got["model"][k], v), k
    assert got["opt"]["step_count"] == want_opt["step_count"] > 0
    for ga, gb in zip(got["opt"]["state"], want_opt["state"]):
        assert sorted(ga) == sorted(gb)
        for k in ga:
            assert all(torch.equal(a, b) for a, b in zip(ga[k], gb[k])), k
    assert not os.path.exists(snap)
    for log in ("log_train.txt", "log_val.txt"):
        assert [r.split(",")[0] for r in rows(f"{stage}/{log}")] \
            == ["epoch", "1", "2", "3"]
