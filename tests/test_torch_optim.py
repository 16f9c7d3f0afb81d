"""The port's optimizer and LR schedules (pixelpick_tpu_torch/engine/optim.py)
against the JAX package's optax chain (pixelpick_tpu/engine/optim.py).

- The per-update step size of Poly and MultiStep, at a small
  iters_per_epoch, across the whole run and the epoch-22/42 drops: equal
  in f32 (both sides compute ``-lr * factor`` in f32).
- Four Adam (and SGD) updates with coupled weight decay on identical
  gradients, backbone at lr/10 and heads at lr: relative 1e-6 (the same f32
  arithmetic, evaluated in other fused orders).
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pixelpick_tpu.engine import optim as jax_optim
from pixelpick_tpu_torch.engine import optim

ITERS = 3


def _args(opt="Adam", sched="MultiStepLR", n_epochs=50):
    params = {"Adam": {"lr": 5e-4, "betas": (0.9, 0.999),
                       "weight_decay": 2e-4, "eps": 1e-7},
              "SGD": {"lr": 1e-2, "weight_decay": 1e-4, "momentum": 0.9}}
    return SimpleNamespace(optimizer_type=opt, optimizer_params=params[opt],
                           lr_scheduler_type=sched, n_epochs=n_epochs,
                           dataset_name="cv", network_name="deeplab")


@pytest.mark.parametrize("sched", ["Poly", "MultiStepLR"])
def test_step_sizes_match_optax_schedule(sched):
    args = _args(sched=sched)
    jax_factor = jax_optim.schedule_factor(args, ITERS)
    table = optim.param_group_table(args)
    opt = optim.Optimizer([(table["backbone"], []), (table["heads"], [])],
                          optim.schedule_factor(args, ITERS))
    steps = np.arange(args.n_epochs * ITERS + 2)
    for name, cfg in table.items():
        ref = np.asarray(jax.vmap(
            lambda s: -cfg["lr"] * jax_factor(s))(jnp.asarray(steps)))
        got = np.array([opt.lr(cfg, int(s)) for s in steps], np.float32)
        np.testing.assert_array_equal(got, ref.astype(np.float32), name)
    if sched == "MultiStepLR":
        # the drops lag the milestones: epochs 1-21 at lr, 22-41 at lr/10
        cfg = table["heads"]
        assert opt.lr(cfg, 21 * ITERS - 1) == pytest.approx(-5e-4)
        assert opt.lr(cfg, 21 * ITERS) == pytest.approx(-5e-5)
        assert opt.lr(cfg, 41 * ITERS) == pytest.approx(-5e-6)


class _Tiny(torch.nn.Module):
    """Named like the model: ``backbone.*`` at lr/10, the rest at lr."""

    def __init__(self, shapes):
        super().__init__()
        self.backbone = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()})
        self.seg_head = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()})


@pytest.mark.parametrize("opt_name", ["Adam", "SGD"])
def test_updates_match_optax(opt_name):
    args = _args(opt=opt_name, sched="Poly", n_epochs=2)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (5,)}
    init = {top: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()}
            for top in ("backbone", "seg_head")}
    model = _Tiny(shapes)
    with torch.no_grad():
        for top in init:
            for k, v in init[top].items():
                getattr(model, top)[k].copy_(torch.from_numpy(v))
    opt = optim.make_optimizer(args, model, ITERS)

    params = jax.tree.map(jnp.asarray, init)
    tx = jax_optim.make_optimizer(args, params, ITERS)
    state = tx.init(params)
    for _ in range(4):
        grads = {top: {k: rng.standard_normal(s).astype(np.float32)
                       for k, s in shapes.items()} for top in init}
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, upd)
        for top in init:
            for k in shapes:
                getattr(model, top)[k].grad = torch.from_numpy(grads[top][k])
        opt.step()
    for top in init:
        for k in shapes:
            np.testing.assert_allclose(
                getattr(model, top)[k].detach().numpy(),
                np.asarray(params[top][k]), rtol=1e-6, atol=1e-7)
