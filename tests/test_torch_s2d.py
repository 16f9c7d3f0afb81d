"""The port's space-to-depth rewrite (``--s2d_backbone``:
pixelpick_tpu_torch/ops/s2d.py, models/s2d_block.py, the s2d blocks of
models/mobilenet_v2.py) against the JAX package's, and against the port's
own standard build; ``remat_blocks`` and the ``xla_nowgrad`` depthwise.

The port is NCHW with the phase-major s2d channel order of JAX's last axis,
so its ``to_s2d`` is JAX's transposed. Shared weights come from JAX's init
through the weight bridge (``state_dict_from_jax``).

Tolerances, f32 on the CPU:
- layout ops (``to_s2d``, ``from_s2d``, ``rep_phase``) exactly;
- ``conv_s2d_1x1``, ``conv_s2d_dw`` and ``border_weight_map`` 1e-6 of the
  reference's largest |value| (the same products, other summation orders);
- one block, eval and train: y 1e-5 of its largest |value|, running
  statistics 1e-5 of theirs (at least 1), parameter gradients 1e-4 of each
  leaf's largest |value| plus 1e-6 of the block's largest gradient (JAX's
  own s2d test holds its blocks to 2e-3);
- whole networks, eval: 1e-4 of the largest |value|; train: the outputs of
  ~10 stacked train-mode BatchNorms amplify f32 reduction-order noise, so
  1e-2 relative plus 3e-3 absolute, as ``tests/test_s2d.py`` holds JAX's
  s2d build to its standard one; the statistics of the rewritten blocks
  1e-4, the later blocks' 1e-2;
- the whole DeepLab's train-step gradients at well-conditioned weights
  (``tests/test_torch_train_step.py`` says why), every leaf within 1e-4 of
  its own largest |value| plus 1e-5 of the step's largest gradient. The
  floor is ten times that test's: the leaves whose true gradient is zero
  (block 16's projection BatchNorm, ASPP's pooled branch over a 1x1 map of
  4 rows) carry rounding noise, and JAX's own s2d and standard builds
  differ by 0.58 of the 1e-6 floor's tolerance on this batch and by 1.9 of
  it on another (seed 13); with the 1e-5 floor, by 0.31 and 0.72
  (``scripts/torch_s2d_grad_noise.py`` prints these);
- remat against the plain build: bit-equal (the same ops in the same order
  on the CPU).
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelpick_tpu.engine import trainer as jax_trainer
from pixelpick_tpu.models import s2d_block as jax_s2d_block
from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
from pixelpick_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from pixelpick_tpu.ops import s2d as jax_s2d
from pixelpick_tpu_torch.engine import trainer
from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.convert import state_dict_from_jax
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.fused_block import FusedIRBlock
from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual
from pixelpick_tpu_torch.models.s2d_block import (
    FusedIRBlockS2D, InvertedResidualS2D,
)
from pixelpick_tpu_torch.ops import fused_ir, s2d
from torch_helpers import (
    HW, N_CLASSES, jax_deeplab_variables, randomise_bn, sparse_batches,
    well_conditioned,
)

WIDTH = 0.5
MEAN, STD = (0.41, 0.43, 0.44), (0.28, 0.29, 0.29)


def nchw(a) -> torch.Tensor:
    """A JAX NHWC array as the port's NCHW tensor in channels_last."""
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


def jit_apply(module):
    """``module.apply``, compiled (``train`` and ``mutable`` static)."""
    return jax.jit(module.apply, static_argnames=("train", "mutable"))


# ------------------------------ ops ------------------------------

def test_layout_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 10, 5)).astype(np.float32)
    z = s2d.to_s2d(nchw(x))
    np.testing.assert_array_equal(nhwc(z), np.asarray(jax_s2d.to_s2d(x)))
    np.testing.assert_array_equal(nhwc(s2d.from_s2d(z)), x)
    v = rng.standard_normal((3, 5)).astype(np.float32)
    np.testing.assert_array_equal(s2d.rep_phase(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax_s2d.rep_phase(v)))
    for p in range(2):
        for k in range(3):
            assert s2d._tap_map(p, k) == jax_s2d._tap_map(p, k)
    with pytest.raises(ValueError):
        s2d.to_s2d(torch.zeros(1, 2, 5, 4))


def test_conv_s2d_1x1_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 4 * 7)).astype(np.float32)
    w = rng.standard_normal((7, 9)).astype(np.float32)
    ref = jax_s2d.conv_s2d_1x1(x, w, precision="highest")
    got = s2d.conv_s2d_1x1(nchw(x), torch.from_numpy(w))
    assert got.shape == (2, 36, 4, 6)
    close(nhwc(got), ref, 1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_s2d_dw_and_border_map_match_jax(stride):
    rng = np.random.default_rng(2 + stride)
    x = rng.standard_normal((2, 5, 7, 4 * 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6)).astype(np.float32)
    ref = jax_s2d.conv_s2d_dw(x, w, stride)
    got = s2d.conv_s2d_dw(nchw(x), torch.from_numpy(w), stride)
    assert got.shape == (2, 24 if stride == 1 else 6, 5, 7)
    close(nhwc(got), ref, 1e-6)
    m_ref = jax_s2d.border_weight_map(w, (10, 14), stride)
    m = s2d.border_weight_map(torch.from_numpy(w), (10, 14), stride)
    close(nhwc(m), m_ref, 1e-6)


# ------------------------------ one block ------------------------------

# (inp, oup, stride, expand ratio): t=1 (block 0's kind), expand + stride 2,
# stride 1 with the residual; JAX's block i of the same expand ratio names
# the weight bridge's keys
BLOCKS = [(6, 4, 1, 1), (4, 6, 2, 6), (6, 6, 1, 6)]


def block_state(variables, t: int) -> dict:
    """A JAX block's variables as the port block's state_dict."""
    i = 0 if t == 1 else 1
    wrap = {k: {"backbone": {f"block_{i}": variables.get(k, {})}}
            for k in ("params", "batch_stats")}
    sd = state_dict_from_jax(wrap["params"], wrap["batch_stats"])
    prefix = f"backbone.features.{i + 1}."
    return {k[len(prefix):]: v for k, v in sd.items()}


def jax_block_vars(cfg, x, seed: int):
    inp, oup, stride, t = cfg
    std = jax_s2d_block.InvertedResidualS2D(inp, oup, stride, t)
    v = std.init({"params": jax.random.PRNGKey(seed)}, x[:1], train=False)
    rng = np.random.default_rng(seed)
    return {"params": randomise_bn(jax.tree.map(np.asarray, v["params"]),
                                   rng),
            "batch_stats": randomise_bn(
                jax.tree.map(np.asarray, v["batch_stats"]), rng)}


def port_block(cfg, variables, bn_groups: int):
    inp, oup, stride, t = cfg
    block = InvertedResidualS2D(inp, oup, stride, 1, t, bn_groups=bn_groups)
    block.load_state_dict(block_state(variables, t))
    return block


@pytest.mark.parametrize("bn_groups", [0, 2])
@pytest.mark.parametrize("cfg", BLOCKS)
def test_block_forward_and_stats_match_jax(cfg, bn_groups):
    """Eval, then two train-mode calls (the running statistics after
    them), of JAX's ``InvertedResidualS2D`` and the port's ``forward_s2d``
    at the same weights."""
    inp, oup, stride, t = cfg
    rng = np.random.default_rng(10 + bn_groups)
    x = jax_s2d.to_s2d(rng.standard_normal((4, 8, 12, inp))
                       .astype(np.float32))
    v = jax_block_vars(cfg, x, seed=3)
    jblock = jax_s2d_block.InvertedResidualS2D(inp, oup, stride, t,
                                               bn_groups=bn_groups)
    block = port_block(cfg, v, bn_groups)
    apply = jit_apply(jblock)
    ref = apply(v, x, train=False)
    with torch.no_grad():
        got = block.eval().forward_s2d(nchw(x))
    close(nhwc(got), ref, 1e-5, "eval")

    block.train()
    for step in range(2):
        xs = jax_s2d.to_s2d(rng.standard_normal((4, 8, 12, inp))
                            .astype(np.float32) + step)
        ref, mut = apply(v, xs, train=True, mutable=("batch_stats",))
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        with torch.no_grad():
            got = block.forward_s2d(nchw(xs))
        close(nhwc(got), ref, 1e-5, f"train step {step}")
    sd = block.state_dict()
    for k, r in block_state(v, t).items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                sd[k].numpy(), r.numpy(), rtol=0,
                atol=1e-5 * max(float(r.abs().max()), 1.0), err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 2, k


@pytest.mark.parametrize("bn_groups", [0, 2])
@pytest.mark.parametrize("cfg", BLOCKS)
def test_block_gradients_match_jax(cfg, bn_groups):
    """Train mode: the gradients of every parameter and of the input under
    a random cotangent, JAX's s2d block against the port's."""
    inp, oup, stride, t = cfg
    rng = np.random.default_rng(20 + bn_groups)
    x = jax_s2d.to_s2d(rng.standard_normal((4, 8, 12, inp))
                       .astype(np.float32))
    v = jax_block_vars(cfg, x, seed=5)
    jblock = jax_s2d_block.InvertedResidualS2D(inp, oup, stride, t,
                                               bn_groups=bn_groups)
    oh, ow = (4, 6)
    cot = rng.standard_normal((4, oh, ow, 4 * oup if stride == 1 else oup)) \
        .astype(np.float32)

    def f(p, xx):
        out, _ = jblock.apply({"params": p, "batch_stats": v["batch_stats"]},
                              xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(v["params"], x)
    ref = block_state({"params": jax.tree.map(np.asarray, gp)}, t)
    ref["x"] = torch.from_numpy(np.array(gx))

    block = port_block(cfg, v, bn_groups).train()
    xt = nchw(x).requires_grad_()
    out = block.forward_s2d(xt)
    names, params = zip(*block.named_parameters())
    grads = torch.autograd.grad((out * nchw(cot)).sum(), [xt, *params])
    got = dict(zip(names, grads[1:]))
    got["x"] = grads[0].permute(0, 2, 3, 1)
    gmax = max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        err = float((got[k] - r).abs().max())
        tol = 1e-4 * float(r.abs().max()) + 1e-6 * gmax
        assert err <= tol, f"{k}: {err} > {tol}"


# ------------------------------ whole networks ------------------------------

@functools.lru_cache(maxsize=None)
def jax_variables():
    """A JAX DeepLab's (params, batch_stats) at width 0.5 with random
    BatchNorm statistics, made once per process (the parameter shapes do
    not depend on the input size)."""
    return jax_deeplab_variables(N_CLASSES, WIDTH, HW, seed=2)


def port_deeplab(params, stats, **kw):
    model = DeepLab(N_CLASSES, width_mult=WIDTH, **kw)
    model.load_state_dict(state_dict_from_jax(params, stats))
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.p = 0.0
    return model.to(memory_format=torch.channels_last)


def test_state_dict_layout_equals_standard():
    """The s2d build's state_dict: the standard build's keys and shapes, in
    the same order, and the same seeded init."""
    from pixelpick_tpu_torch.models.factory import init_model

    std = init_model(DeepLab(N_CLASSES, width_mult=WIDTH), 3).state_dict()
    ours = init_model(DeepLab(N_CLASSES, width_mult=WIDTH, s2d_until=4),
                      3).state_dict()
    assert list(ours) == list(std)
    for k, v in std.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("hw", [HW, (40, 56)])
def test_mobilenet_s2d_eval_matches_jax(hw):
    """The backbone alone (high and low features) in eval mode, JAX's
    ``MobileNetV2(s2d_until=4)`` against the port's; at 40x56 blocks 2 and
    3 run on a grid of 5x7 cells."""
    params, stats = jax_variables()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jnet = JaxMobileNetV2(width_mult=WIDTH, s2d_until=4)
    hi, lo = jit_apply(jnet)({"params": params["backbone"],
                         "batch_stats": stats["backbone"]}, x, train=False)
    model = port_deeplab(params, stats, s2d_until=4).eval()
    with torch.no_grad():
        h, low = model.backbone(nchw(x))
    close(nhwc(h), hi, 1e-4, "high")
    close(nhwc(low), lo, 1e-4, "low")


@pytest.mark.parametrize("bn_groups", [0, 2])
def test_mobilenet_s2d_train_matches_jax(bn_groups):
    """Train mode: the features and every running statistic after one
    call, JAX's s2d build against the port's."""
    params, stats = jax_variables()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, *HW, 3)).astype(np.float32)
    jnet = JaxMobileNetV2(width_mult=WIDTH, s2d_until=4, bn_groups=bn_groups)
    (hi, lo), mut = jit_apply(jnet)({"params": params["backbone"],
                                "batch_stats": stats["backbone"]}, x,
                               train=True, mutable=("batch_stats",))
    model = port_deeplab(params, stats, s2d_until=4, bn_groups=bn_groups)
    model.train()
    with torch.no_grad():
        h, low = model.backbone(nchw(x))
    for got, ref in ((h, hi), (low, lo)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(nhwc(got), ref, rtol=1e-2, atol=3e-3)
    ref_sd = state_dict_from_jax({}, {"backbone": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    sd = model.state_dict()
    for k, r in ref_sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
            continue
        rewritten = any(f"features.{i}." in k for i in range(5))
        tol = 1e-4 if rewritten else 1e-2
        np.testing.assert_allclose(
            sd[k].numpy(), r.numpy(), rtol=0,
            atol=tol * max(float(r.abs().max()), 1.0), err_msg=k)


def test_deeplab_s2d_eval_matches_jax_and_standard():
    """DeepLab's logits: the port's s2d build against JAX's s2d build and
    against the port's standard build."""
    params, stats = jax_variables()
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, *HW, 3)).astype(np.float32)
    ref = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH, s2d_until=4) \
        .apply({"params": params, "batch_stats": stats}, x, train=False,
               upsample=False)["pred"]
    with torch.no_grad():
        got = port_deeplab(params, stats, s2d_until=4).eval()(
            torch.from_numpy(x), upsample=False)["pred"]
        std = port_deeplab(params, stats).eval()(
            torch.from_numpy(x), upsample=False)["pred"]
    close(got.numpy(), ref, 1e-4, "vs JAX")
    close(got.numpy(), std.numpy(), 1e-4, "vs the standard build")


def test_odd_shapes_fall_back():
    """A 20x28 input (stem 10x14, then 5x7): block 0 and 1 run s2d, blocks
    2 and 3 the standard way, and the features equal the standard build's
    and JAX's s2d build's."""
    params, stats = jax_variables()
    x = np.random.default_rng(12).standard_normal((1, 20, 28, 3)) \
        .astype(np.float32)
    model = port_deeplab(params, stats, s2d_until=4).eval()
    calls = []
    for i, block in enumerate(model.backbone.features[1:5]):
        block.register_forward_hook(lambda *a, i=i: calls.append(i))
    with torch.no_grad():
        h, low = model.backbone(nchw(x))
        h_std, low_std = port_deeplab(params, stats).eval().backbone(nchw(x))
    assert calls == [2, 3]  # the standard forward of the fallen-back blocks
    assert h.shape[1] == int(320 * WIDTH) and low.shape[1] == int(24 * WIDTH)
    hi, lo = jit_apply(JaxMobileNetV2(width_mult=WIDTH, s2d_until=4))(
        {"params": params["backbone"], "batch_stats": stats["backbone"]}, x,
        train=False)
    close(nhwc(h), hi, 1e-4)
    close(nhwc(low), lo, 1e-4)
    close(nhwc(h), nhwc(h_std), 1e-4)


def _step_grads(model, batch):
    x = trainer.normalize_images(torch.from_numpy(batch["x"]), MEAN, STD)
    out = model(x, upsample=False)
    loss, _ = trainer.sparse_ce_and_hist(
        out["pred"], torch.from_numpy(batch["coords"]),
        torch.from_numpy(batch["labels"]), torch.from_numpy(batch["valid"]),
        HW, N_CLASSES)
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def test_deeplab_s2d_train_step_gradients_match_jax(monkeypatch):
    """The sparse loss and every parameter gradient of one train step of
    the whole DeepLab, JAX's s2d build against the port's, at
    well-conditioned weights."""
    params, stats = jax_variables()
    params = well_conditioned(params, np.random.default_rng(102))
    batch = sparse_batches(1)[0]
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    jmodel = JaxDeepLab(n_classes=N_CLASSES, width_mult=WIDTH, s2d_until=4)
    loss_fn = jax_trainer._sparse_loss_fn(
        jmodel, n_classes=N_CLASSES, mean=MEAN, std=STD, normalize=True,
        gather_impl="matmul")
    (loss_j, (stats_j, _)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    ref = state_dict_from_jax(jax.tree.map(np.asarray, grads_j),
                              jax.tree.map(np.asarray, stats_j))
    model = port_deeplab(params, stats, s2d_until=4).train()
    loss, grads = _step_grads(model, batch)
    loss, loss_j = float(loss.detach()), float(loss_j)
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    gmax = max(float(ref[n].abs().max()) for n in grads)
    for n, g in grads.items():
        err = float((g - ref[n]).abs().max())
        tol = 1e-4 * float(ref[n].abs().max()) + 1e-5 * gmax
        assert err <= tol, f"grad {n}: {err} > {tol}"
    sd = model.state_dict()
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * max(float(r.abs().max()), 1.0)
            assert float((sd[k] - r).abs().max()) <= tol, k


def test_fused_ir_with_s2d_on_the_plain_versions(monkeypatch):
    """``--fused_ir --s2d_backbone``: block 2 is an s2d block (its fused
    fallback kept for odd sizes), the other 12 stride-1 t=6 blocks are
    fused and call the fused block 12 times per train forward; the
    features equal the unfused s2d build's."""
    params, stats = jax_variables()
    fused = port_deeplab(params, stats, s2d_until=4, fused_ir=True).train()
    plain = port_deeplab(params, stats, s2d_until=4).train()
    blocks = list(fused.backbone.features[1:])
    assert isinstance(blocks[2], FusedIRBlockS2D)
    assert sum(type(b) is FusedIRBlock for b in blocks) == 12
    assert [i for i, b in enumerate(blocks)
            if isinstance(b, InvertedResidualS2D)] == [0, 1, 2, 3]
    calls = []
    real = fused_ir.fused_ir_block

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_ir, "fused_ir_block", counted)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (4, *HW, 3)).astype(np.float32))
    with torch.no_grad():
        a = fused(x, upsample=False)["pred"]
        assert len(calls) == 12
        b = plain(x, upsample=False)["pred"]
    close(a.numpy(), b.numpy(), 1e-4)
    # at an odd size block 2 takes the fused block's forward, as JAX does
    calls.clear()
    with torch.no_grad():
        fused.backbone(torch.zeros(4, 3, 20, 28))
    assert len(calls) == 13


@pytest.mark.parametrize("s2d_until", [0, 4])
def test_remat_blocks_bit_equal(s2d_until):
    """``remat_blocks``: one train step's loss, every gradient and every
    running statistic (the EMA applied once) bit-equal to the plain
    build's."""
    params, stats = jax_variables()
    batch = sparse_batches(1, seed=17)[0]
    plain = port_deeplab(params, stats, s2d_until=s2d_until).train()
    remat = port_deeplab(params, stats, s2d_until=s2d_until,
                         remat_blocks=True).train()
    assert sum(isinstance(m, InvertedResidual) and m.remat
               for m in remat.modules()) == 17
    calls = []
    real = layers.BatchNorm.update_running_stats

    def counted(self, *a, **k):
        calls.append(self)
        return real(self, *a, **k)

    loss_p, grads_p = _step_grads(plain, batch)
    layers.BatchNorm.update_running_stats = counted
    try:
        loss_r, grads_r = _step_grads(remat, batch)
    finally:
        layers.BatchNorm.update_running_stats = real
    # the recompute ran the rematerialised blocks' BatchNorms again
    assert len(calls) > sum(isinstance(m, layers.BatchNorm)
                            for m in remat.modules())
    assert torch.equal(loss_p, loss_r)
    for n, g in grads_p.items():
        assert torch.equal(g, grads_r[n]), n
    sp, sr = plain.state_dict(), remat.state_dict()
    for k, v in sp.items():
        assert torch.equal(v, sr[k]), k
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_xla_nowgrad_depthwise_takes_no_weight_gradient():
    """``set_depthwise_impl('xla_nowgrad')``: the depthwise convs are
    ``DepthwiseNoWgrad`` with the standard forward, and the backward gives
    their weights no gradient while every other weight has one."""
    params, stats = jax_variables()
    layers.set_depthwise_impl("xla_nowgrad")
    try:
        model = port_deeplab(params, stats).train()
    finally:
        layers.set_depthwise_impl("xla")
    std = port_deeplab(params, stats).train()
    dws = {n for n, m in model.named_modules()
           if isinstance(m, layers.DepthwiseNoWgrad)}
    assert len(dws) == 17
    batch = sparse_batches(1, seed=19)[0]
    x = trainer.normalize_images(torch.from_numpy(batch["x"]), MEAN, STD)
    out = model(x, upsample=False)["pred"]
    with torch.no_grad():
        close(out.detach().numpy(), std(x, upsample=False)["pred"].numpy(),
              1e-5)
    out.square().mean().backward()
    for n, p in model.named_parameters():
        module = n.rsplit(".", 1)[0]
        if module in dws:
            assert p.grad is None, n
        elif n.endswith("weight") and p.dim() == 4:
            assert p.grad is not None and float(p.grad.abs().max()) > 0, n
