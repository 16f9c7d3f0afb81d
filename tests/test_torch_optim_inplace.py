"""The port's optimizer updates its moments in place
(``pixelpick_tpu_torch/engine/optim.py:Optimizer``), with the step size and
Adam's bias corrections read from device scalars, so that a CUDA graph of
its arithmetic serves every update. On the CPU, at toy sizes:

- five SGD and Adam updates (both groups, weight decay, a parameter
  without a gradient) equal, bit for bit, the update that rebound new
  moment lists each step, kept here as it was;
- ``load_state_dict`` writes into the moment tensors there are (their
  ``data_ptr`` stays) and installs the saved values;
- zeroing the moments in place and setting ``step_count = 0`` (the
  benchmark's reset) reproduces the first run bit for bit;
- the device scalars hold ``lr(cfg, t)`` and the bias corrections of
  update ``t``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pixelpick_tpu_torch.engine import optim

ITERS = 3
N_UPDATES = 5
SHAPES = {"w": (4, 3), "b": (5,), "idle": (2, 2)}  # "idle" gets no gradient


def _args(opt):
    params = {"Adam": {"lr": 5e-4, "betas": (0.9, 0.999),
                       "weight_decay": 2e-4, "eps": 1e-7},
              "SGD": {"lr": 1e-2, "weight_decay": 1e-4, "momentum": 0.9}}
    return SimpleNamespace(optimizer_type=opt, optimizer_params=params[opt],
                           lr_scheduler_type="Poly", n_epochs=2,
                           dataset_name="cv", network_name="deeplab")


class _Tiny(torch.nn.Module):
    """Named like the model: ``backbone.*`` at lr/10, the rest at lr."""

    def __init__(self, seed: int):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.backbone = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.randn(s, generator=g))
             for k, s in SHAPES.items()})
        self.seg_head = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.randn(s, generator=g))
             for k, s in SHAPES.items()})


def _grads(seed: int, n: int):
    """Per update, a gradient for every parameter but the ``idle`` ones."""
    g = torch.Generator().manual_seed(seed)
    return [{f"{top}.{k}": torch.randn(s, generator=g)
             for top in ("backbone", "seg_head")
             for k, s in SHAPES.items() if k != "idle"}
            for _ in range(n)]


def _set_grads(model, grads):
    for name, p in model.named_parameters():
        p.grad = grads[name].clone() if name in grads else None


class _Rebinding:
    """The update as it was before the moments were written in place: new
    moment lists every step, the step size and the bias corrections as
    host floats."""

    def __init__(self, opt: optim.Optimizer):
        self.opt = opt
        self.state = [{k: [t.clone() for t in ts] for k, ts in st.items()}
                      for st in opt.state]
        self.step_count = 0

    @torch.no_grad()
    def step(self):
        t = self.step_count
        for (cfg, ps), st in zip(self.opt.groups, self.state):
            if not ps:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in ps]
            if cfg["wd"]:
                grads = torch._foreach_add(grads, ps, alpha=cfg["wd"])
            if cfg["opt"] == "adam":
                b1, b2 = cfg["betas"]
                mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                        torch._foreach_mul(st["mu"], b1))
                sq = torch._foreach_mul(grads, grads)
                nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                        torch._foreach_mul(st["nu"], b2))
                st["mu"], st["nu"] = mu, nu
                count = np.float32(t + 1)
                bc1 = float(np.float32(1) - np.float32(b1) ** count)
                bc2 = float(np.float32(1) - np.float32(b2) ** count)
                denom = torch._foreach_add(
                    torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                    cfg["eps"])
                upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            else:
                upd = torch._foreach_add(
                    grads, torch._foreach_mul(st["trace"], cfg["momentum"]))
                st["trace"] = upd
            torch._foreach_add_(ps, torch._foreach_mul(upd,
                                                       self.opt.lr(cfg, t)))
        self.step_count += 1


def _run(opt_name: str, updates, seed: int = 0):
    """A model and optimizer after ``updates`` (each a gradient dict)."""
    model = _Tiny(seed)
    opt = optim.make_optimizer(_args(opt_name), model, ITERS)
    for grads in updates:
        _set_grads(model, grads)
        opt.step()
    return model, opt


def _state_of(model, opt):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            [{k: [t.clone() for t in ts] for k, ts in st.items()}
             for st in opt.state])


def _assert_bit_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_in_place_updates_equal_the_rebinding_update(opt_name):
    updates = _grads(1, N_UPDATES)
    model, opt = _run(opt_name, [])
    ref_model = _Tiny(0)
    ref = _Rebinding(optim.make_optimizer(_args(opt_name), ref_model, ITERS))
    ids = [[t.data_ptr() for ts in st.values() for t in ts]
           for st in opt.state]
    for i, grads in enumerate(updates):
        _set_grads(model, grads)
        opt.step()
        _set_grads(ref_model, grads)
        ref.step()
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  ref_model.named_parameters()):
            _assert_bit_equal(p.detach(), q.detach(), (i, n))
        for st, st_ref in zip(opt.state, ref.state):
            for k in st:
                for j, (t, u) in enumerate(zip(st[k], st_ref[k])):
                    _assert_bit_equal(t, u, (i, k, j))
    assert opt.step_count == N_UPDATES
    # the moments were written where they lay
    assert ids == [[t.data_ptr() for ts in st.values() for t in ts]
                   for st in opt.state]


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_load_state_dict_writes_into_the_moments(opt_name):
    saved_model, saved = _run(opt_name, _grads(2, 3), seed=1)
    sd = saved.state_dict()
    model, opt = _run(opt_name, _grads(3, 1))
    ptrs = [[t.data_ptr() for t in ts] for st in opt.state
            for ts in st.values()]
    opt.load_state_dict(sd)
    assert opt.step_count == 3
    assert ptrs == [[t.data_ptr() for t in ts] for st in opt.state
                    for ts in st.values()]
    for st, st_saved in zip(opt.state, sd["state"]):
        for k in st:
            for t, u in zip(st[k], st_saved[k]):
                _assert_bit_equal(t, u, k)
    # the same parameters and state then make the same update
    with torch.no_grad():
        for p, q in zip(model.parameters(), saved_model.parameters()):
            p.copy_(q)
    grads = _grads(4, 1)[0]
    for m, o in ((model, opt), (saved_model, saved)):
        _set_grads(m, grads)
        o.step()
    for p, q in zip(model.parameters(), saved_model.parameters()):
        _assert_bit_equal(p.detach(), q.detach(), "after load")
    # a state that does not fit leaves the moments as they were
    bad = opt.state_dict()
    key = next(iter(bad["state"][0]))
    bad["state"][0][key][0] = torch.zeros(7)
    before = _state_of(model, opt)[1]
    with pytest.raises(ValueError):
        opt.load_state_dict(bad)
    for st, st_before in zip(opt.state, before):
        for k in st:
            for t, u in zip(st[k], st_before[k]):
                _assert_bit_equal(t, u, ("refused", k))


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_a_reset_in_place_reproduces_the_first_run(opt_name):
    updates = _grads(5, N_UPDATES)
    model, opt = _run(opt_name, [])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = []
    for _ in range(2):
        # the benchmark's reset: weights copied in, moments zeroed in place,
        # the count set by assignment
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        for st in opt.state:
            for ts in st.values():
                torch._foreach_zero_(ts)
        opt.step_count = 0
        for grads in updates:
            _set_grads(model, grads)
            opt.step()
        runs.append(_state_of(model, opt))
    (params_a, state_a), (params_b, state_b) = runs
    for n in params_a:
        _assert_bit_equal(params_a[n], params_b[n], n)
    for st_a, st_b in zip(state_a, state_b):
        for k in st_a:
            for t, u in zip(st_a[k], st_b[k]):
                _assert_bit_equal(t, u, k)


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_the_device_scalars_hold_each_updates_values(opt_name):
    model, opt = _run(opt_name, [])
    for t in range(2 * ITERS + 2):
        opt.step_count = t
        opt.prepare()
        for (cfg, _), sc in zip(opt.groups, opt.scalars):
            assert sc["lr"].dtype == torch.float32
            assert float(sc["lr"]) == opt.lr(cfg, t)
            if cfg["opt"] == "adam":
                b1, b2 = (np.float32(b) for b in cfg["betas"])
                n = np.float32(t + 1)
                assert float(sc["bc1"]) == float(np.float32(1) - b1 ** n)
                assert float(sc["bc2"]) == float(np.float32(1) - b2 ** n)
            else:
                assert set(sc) == {"lr"}
    # filling them changes no host state
    assert opt.step_count == 2 * ITERS + 1
    # an empty group holds none
    empty = optim.Optimizer([(optim.param_group_table(_args(opt_name))
                              ["heads"], [])], lambda s: 1.0)
    assert empty.scalars == [{}]
    empty.step()
    assert empty.step_count == 1
