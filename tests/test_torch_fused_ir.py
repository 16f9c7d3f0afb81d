"""The port's fused inverted-residual block (ops/fused_ir.py,
models/fused_block.py) against the JAX package's: ``fused_ir_block`` with
its Pallas kernels in interpret mode, and the JAX ``FusedIRBlock``. On the
CPU the port runs the kernels' plain versions.

Tolerances are the JAX package's own (tests/test_fused_ir.py): y and the six
moments f32 3e-5 / bf16 4e-2 absolute; gradients relative to the largest
|gradient| of the ten, f32 1e-4 / bf16 4e-2 (near-zero BatchNorm-parameter
gradients are sums with much cancellation, and a bf16 value on either side
of a rounding boundary moves by one bf16 ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pixelpick_tpu.models.fused_block import FusedIRBlock as JaxFusedIRBlock
from pixelpick_tpu.ops import fused_ir as jax_fused
from pixelpick_tpu_torch.models.fused_block import FusedIRBlock
from pixelpick_tpu_torch.ops import fused_ir

B, H, W = 8, 9, 10
SHAPES = [(16, 16, 1), (16, 24, 1), (16, 16, 2)]  # (ci, co, dilation)
FTOL = {"float32": 3e-5, "bfloat16": 4e-2}
GTOL = {"float32": 1e-4, "bfloat16": 4e-2}


def _block_inputs(ci, co, seed=0, b=B):
    rng = np.random.default_rng(seed)
    ch = 6 * ci
    x = rng.standard_normal((b, H, W, ci)).astype(np.float32)
    ws = [rng.standard_normal((ci, ch)) / np.sqrt(ci),
          rng.standard_normal((3, 3, ch)) / 3,
          rng.standard_normal((ch, co)) / np.sqrt(ch)]
    bn = []
    for c in (ch, ch, co):
        bn += [rng.uniform(0.5, 1.5, c), 0.1 * rng.standard_normal(c)]
    dy = rng.standard_normal((b, H, W, co)).astype(np.float32)
    return x, [np.asarray(a, np.float32) for a in ws + bn], dy


def _jax_vjp(x, weights, dy, group, d, use_res, dtype):
    jdt = jnp.dtype(dtype)
    args = [jnp.asarray(x, jdt)] + [jnp.asarray(a, jdt) for a in weights[:3]] \
        + [jnp.asarray(a) for a in weights[3:]]

    @jax.jit
    def run(*a):
        (y, stats), pull = jax.vjp(
            lambda *t: jax_fused.fused_ir_block(*t, group, d, use_res, True),
            *a)
        zeros = tuple(jnp.zeros_like(s) for s in stats)
        return y, stats, pull((jnp.asarray(dy, jdt), zeros))

    y, stats, grads = run(*args)
    f = lambda t: np.asarray(jnp.asarray(t, jnp.float32))  # noqa: E731
    return f(y), [f(s) for s in stats], [f(g) for g in grads]


def _port_vjp(x, weights, dy, group, d, use_res, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt)] \
        + [torch.from_numpy(a).to(tdt) for a in weights[:3]] \
        + [torch.from_numpy(a) for a in weights[3:]]
    leaves = [t.requires_grad_() for t in leaves]
    y, stats = fused_ir.fused_ir_block(*leaves, group, d, use_res)
    assert y.dtype == tdt and all(s.dtype == torch.float32 for s in stats)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(tdt))
    f = lambda t: t.detach().float().numpy()  # noqa: E731
    return f(y), [f(s) for s in stats], [f(g) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("ci,co,d", SHAPES)
def test_block_matches_jax_interpret_kernel(ci, co, d, group, dtype):
    x, weights, dy = _block_inputs(ci, co, seed=ci + co + d + group)
    use_res = ci == co
    ref = _jax_vjp(x, weights, dy, group, d, use_res, dtype)
    got = _port_vjp(x, weights, dy, group, d, use_res, dtype)
    assert got[0].shape == (B, H, W, co)
    assert [s.shape for s in got[1]] == [s.shape for s in ref[1]]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=FTOL[dtype])
    for a, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(a, r, rtol=0, atol=FTOL[dtype])
    gmax = max(np.abs(r).max() for r in ref[2])
    for a, r in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, r, rtol=0, atol=GTOL[dtype] * gmax)


def test_twelve_groups_add_their_gradients():
    """Batch 48 in ghost-BN groups of 4: twelve groups, each with its own
    moments, whose parameter gradients add up in f32."""
    x, weights, dy = _block_inputs(16, 16, seed=7, b=48)
    x, dy = x[:, :5, :6].copy(), dy[:, :5, :6].copy()
    ref = _jax_vjp(x, weights, dy, 4, 1, True, "float32")
    got = _port_vjp(x, weights, dy, 4, 1, True, "float32")
    assert [s.shape[0] for s in got[1]] == [12] * 6
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=3e-5)
    for a, r in zip(got[1], ref[1]):
        np.testing.assert_allclose(a, r, rtol=0, atol=3e-5)
    gmax = max(np.abs(r).max() for r in ref[2])
    for a, r in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-4 * gmax)


def tie_inputs(seed=5, group=4):
    """Inputs whose BN + ReLU6 outputs hit exactly 0 and 6, and whose
    depthwise BN sees a zero variance.

    Stage 1: hidden channels 0 and 1 copy input channel 0, which is +1 on
    half of each group's pixels and -1 on the other half, so their mean is
    exactly 0 and the zero-padded border normalises to exactly beta: 0 for
    channel 0 and 6 for channel 1. Stage 2: hidden channels 2 and 3 have
    zero depthwise taps, so they are constant (variance exactly 0) and
    normalise to beta everywhere: 6 and 0."""
    ci = co = 16
    x, weights, dy = _block_inputs(ci, co, seed=seed)
    rng = np.random.default_rng(seed)
    for g0 in range(0, B, group):
        signs = np.repeat([1.0, -1.0], group * H * W // 2)
        x[g0:g0 + group, :, :, 0] = rng.permutation(signs).reshape(group, H, W)
    we, wd, _, _, b1, _, b2, _, _ = weights
    we[:, :2] = 0.0
    we[0, :2] = 1.0
    b1[0], b1[1] = 0.0, 6.0
    # taps that sum to 0, so the depthwise output of those nearly constant
    # channels has a small mean and its fast variance does not cancel
    wd[:, :, :2] = np.array([[0.5, -0.5, 0.25], [-0.25, 0.0, 0.75],
                             [-0.75, 0.125, -0.125]], np.float32)[..., None]
    wd[:, :, 2:4] = 0.0
    b2[2], b2[3] = 6.0, 0.0
    return x, weights, dy


def test_relu6_and_variance_ties_take_half_the_gradient():
    """JAX's min/max pass 0.5 of the gradient at exact ties (ReLU6 at 0 and
    6, the variance's max(0, .) at 0); the port's plain version must agree
    with JAX on every gradient, the tie channels included."""
    x, weights, dy = tie_inputs()
    ref = _jax_vjp(x, weights, dy, 4, 1, True, "float32")
    got = _port_vjp(x, weights, dy, 4, 1, True, "float32")
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=3e-5)
    assert ref[1][0][:, :2].max() == 0.0  # mu1 == 0: the border ties
    assert ref[1][3][:, 2:4].max() == 0.0  # var2 == 0
    for a, r in zip(got[2], ref[2]):
        np.testing.assert_allclose(a, r, rtol=0,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-6))
    # the stage-1 tie channels carry gradient, so their 0.5 is seen; the
    # constant stage-2 channels' bias gradients vanish whatever the rule
    # (BN3 removes any constant), so they only show that nothing breaks
    db1 = got[2][5]
    assert min(abs(db1[0]), abs(db1[1])) > 1e-2


def _jax_block_variables(ci, co, d, groups, seed=0):
    rng = np.random.default_rng(seed)
    blk = JaxFusedIRBlock(ci, co, 1, d, 6, bn_groups=groups)
    x = jnp.zeros((B, H, W, ci), jnp.float32)
    v = jax.tree.map(np.asarray,
                     blk.init(jax.random.PRNGKey(seed), x, train=False))
    for name in ("expand_bn", "dw_bn", "project_bn"):
        c = v["params"][name]["bn"]["scale"].shape[0]
        v["params"][name]["bn"] = {
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        v["batch_stats"][name]["bn"] = {
            "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return blk, v


def _port_block(v, ci, co, d, groups, cls=FusedIRBlock):
    """The port's block at the JAX block's variables (the layout of
    ``state_dict_from_jax``: ``conv.{0,1,3,4,6,7}``)."""
    blk = cls(ci, co, 1, d, 6, bn_groups=groups)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for name, j in (("expand", 0), ("dw", 3), ("project", 6)):
        sd[f"conv.{j}.weight"] = torch.from_numpy(
            np.ascontiguousarray(p[name]["kernel"].transpose(3, 2, 0, 1)))
    for name, j in (("expand_bn", 1), ("dw_bn", 4), ("project_bn", 7)):
        sd[f"conv.{j}.weight"] = torch.from_numpy(p[name]["bn"]["scale"])
        sd[f"conv.{j}.bias"] = torch.from_numpy(p[name]["bn"]["bias"])
        sd[f"conv.{j}.running_mean"] = torch.from_numpy(s[name]["bn"]["mean"])
        sd[f"conv.{j}.running_var"] = torch.from_numpy(s[name]["bn"]["var"])
        sd[f"conv.{j}.num_batches_tracked"] = torch.tensor(0)
    blk.load_state_dict(sd)
    return blk.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("groups", [4, 3])  # 3: B % 3 != 0, group = B
def test_module_forward_and_ema_match_jax_fused_block(groups):
    ci, co, d = 16, 24, 1
    blk, v = _jax_block_variables(ci, co, d, groups)
    x = np.random.default_rng(1).standard_normal((B, H, W, ci)) \
        .astype(np.float32)
    yj, mut = blk.apply(v, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    port = _port_block(v, ci, co, d, groups).train()
    fused_ir.reset_launch_counts()
    with torch.no_grad():
        yt = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), np.asarray(yj),
                               rtol=0, atol=3e-5)
    sj = mut["batch_stats"]
    for name, j in (("expand_bn", 1), ("dw_bn", 4), ("project_bn", 7)):
        bn = port.conv[j]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(sj[name]["bn"]["mean"]),
                                   rtol=0, atol=3e-5, err_msg=name)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(sj[name]["bn"]["var"]),
                                   rtol=0, atol=3e-5, err_msg=name)
        assert int(bn.num_batches_tracked) == 1


def test_module_eval_path_matches_jax():
    """Eval mode takes the inline unfused math with running statistics."""
    ci, co, d = 16, 16, 2
    blk, v = _jax_block_variables(ci, co, d, 4, seed=3)
    x = np.random.default_rng(2).standard_normal((B, H, W, ci)) \
        .astype(np.float32)
    yj = blk.apply(v, jnp.asarray(x), train=False)
    port = _port_block(v, ci, co, d, 4).eval()
    with torch.no_grad():
        yt = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), np.asarray(yj),
                               rtol=0, atol=1e-5)


def test_module_gradients_match_unfused_block():
    """The fused module's parameter gradients against the port's own
    unfused ``InvertedResidual`` at the same weights (autograd through the
    modules), as tests/test_fused_ir.py holds the JAX pair."""
    from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual

    ci, co, d = 16, 16, 1
    _, v = _jax_block_variables(ci, co, d, 4, seed=4)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, H, W, ci)).astype(np.float32)).permute(0, 3, 1, 2)
    grads = []
    for cls in (FusedIRBlock, InvertedResidual):
        m = _port_block(v, ci, co, d, 4, cls).train()
        out = m(x)
        (out.float() ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
    gmax = max(float(g.abs().max()) for g in grads[1].values())
    for n, g in grads[1].items():
        assert float((grads[0][n] - g).abs().max()) < 1e-4 * gmax, n


@pytest.mark.parametrize("group,d,co", [(3, 1, 16), (0, 1, 16), (4, 0, 16),
                                        (4, 1, 24)])
def test_block_refuses_shapes_that_are_not_a_block(group, d, co):
    """A group that does not divide the batch, a dilation below 1, or a
    residual between unequal widths raises on the plain path too (the
    kernels' entries check the same), instead of dropping images."""
    x, weights, _ = _block_inputs(16, co)
    leaves = [torch.from_numpy(x)] + [torch.from_numpy(a) for a in weights]
    with pytest.raises(ValueError, match="bad group"):
        fused_ir.fused_ir_block(*leaves, group, d, True)


def test_kernel_entries_refuse_cpu_tensors():
    """The CUDA entries never fall back: a CPU tensor raises."""
    x, weights, dy = _block_inputs(16, 16)
    xt = torch.from_numpy(x)
    wt = tuple(torch.from_numpy(a) for a in weights)
    fused_ir.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ir.fused_fwd_kernel(xt, wt, 4, 1, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ir.fused_bwd_kernel(xt, torch.from_numpy(dy), wt, 4, 1, True)
    assert fused_ir.launch_counts["fused_fwd"] == 0
    assert fused_ir.launch_counts["fused_bwd"] == 0


def test_bridge_loads_a_fused_jax_deeplab():
    """``state_dict_from_jax`` carries a JAX ``DeepLab(fused_ir=True)``
    tree into the port's fused DeepLab unchanged: same keys, same values."""
    from pixelpick_tpu.models.deeplab import DeepLab as JaxDeepLab
    from pixelpick_tpu_torch.models.convert import state_dict_from_jax
    from pixelpick_tpu_torch.models.deeplab import DeepLab

    model = JaxDeepLab(n_classes=11, width_mult=0.5, fused_ir=True)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)),
                                     train=False))(jax.random.PRNGKey(0))
    v = jax.tree.map(np.asarray, v)
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    port = DeepLab(11, width_mult=0.5, fused_ir=True)
    assert sum(isinstance(m, FusedIRBlock) for m in port.modules()) == 13
    port.load_state_dict(sd)
    for k, t in port.state_dict().items():
        assert torch.equal(t, sd[k]), k


@pytest.mark.parametrize("shape", [(4, 90, 120, 24, 144, 24, 1),
                                   (4, 23, 30, 160, 960, 320, 2)])
def test_block_flops_counts_no_recompute(shape):
    """The backward kernel reads the forward's saved h1, h2, h3, so its
    operations are twice the forward's (each product's data and weight
    gradients, the depthwise's two), with no recomputed forward on top."""
    b, h, w, cin, ch, cout, d = shape
    fwd, bwd = fused_ir.block_flops(*shape)
    assert fwd == 2 * b * (h + 2 * d) * (w + 2 * d) * cin * ch \
        + 18 * b * h * w * ch + 2 * b * h * w * ch * cout
    assert bwd == 2 * fwd


@pytest.mark.parametrize("shape", [(4, 90, 120, 24, 24, 1),
                                   (4, 23, 30, 160, 320, 2)])
def test_forward_trace_counts_the_block_operations(shape):
    """``scripts/torch_trace_fused_fwd.py`` divides each forward phase's
    operations by its time; its expand (over the padded domain), depthwise
    and project together are ``block_flops``' forward count. It loads
    without a card, with the backward script's helpers."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" \
        / "torch_trace_fused_fwd.py"
    spec = importlib.util.spec_from_file_location("trace_fused_fwd", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert "torch_trace_fused_bwd" in sys.modules
    b, h, w, cin, cout, d = shape
    ops = [script.phase_work(role, shape)[0]
           for role in ("expand", "depthwise (dw_forward)", "project")]
    assert ops[0] == 2 * b * (h + 2 * d) * (w + 2 * d) * cin * 6 * cin
    assert sum(ops) == fused_ir.block_flops(b, h, w, cin, 6 * cin, cout,
                                            d)[0]
    assert script.phase_work("BN1 finish (moments_finish)", shape) is None
