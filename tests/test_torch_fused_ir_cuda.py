"""The fused inverted-residual kernels (pixelpick_tpu_torch/csrc/fused_ir.cu)
against their plain PyTorch versions, on a CUDA card. Skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_ir_cuda.py

Tolerances: y relative to its largest |value|, as tests/test_fused_ir.py
holds it; each of the ten gradients relative to its own largest |value|, or
to 1e-3 of the largest of the ten where its own is smaller (a near-zero
gradient). f32 1e-4 (the same sums in other orders, through three
BatchNorms that divide by standard deviations); moments 1e-5. bf16 4e-2, or
twice how far the plain version itself moves between bf16 and f32 on the
same inputs where that is more: a value on either side of a bf16 rounding
boundary moves by one bf16 ulp (2**-8 relative), and dx and the
BatchNorm-parameter gradients are sums with much cancellation. The first
two BatchNorms' biases lie in [1, 2], so few ReLU6 inputs come near the
kink at 0, where two summation orders may take different branches.
"""

import numpy as np
import pytest
import torch

from pixelpick_tpu_torch.ops import fused_ir

SHAPES = [  # (B, H, W, Cin, Cout, dilation, group)
    (4, 9, 10, 16, 16, 1, 4),
    (3, 11, 13, 16, 24, 1, 3),     # remainder batch, Cin != Cout
    (8, 7, 9, 24, 24, 2, 4),       # two groups, dilation 2; hidden 144
    (2, 23, 30, 64, 64, 1, 2),     # hidden 384: 128-wide tiles
    (48, 5, 6, 16, 16, 1, 4),      # 12 groups whose gradients add up
    # widths that reach each tile width the backward's products choose
    # (32, 64, 128), ragged ones among them
    (2, 7, 9, 20, 28, 1, 2),       # hidden 120
    (2, 6, 7, 40, 200, 1, 1),      # hidden 240, 200 out
    (1, 5, 6, 200, 40, 2, 1),      # hidden 1200; the expand splits its depth
    (2, 5, 6, 160, 160, 1, 2),     # hidden 960; the expand splits its depth
    # the forward's plans: the expand 128 wide; the project 64 and 128
    # wide; the main path's 23x30 project, 32 wide and split six ways over
    # its depth to fill the card
    (4, 38, 38, 64, 128, 1, 4),
    (4, 60, 80, 16, 64, 1, 4),
    (4, 64, 70, 16, 128, 1, 4),
    (4, 23, 30, 64, 64, 1, 4),
]


def _inputs(b, h, w, cin, cout, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ch = 6 * cin

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    x = t(rng.standard_normal((b, h, w, cin)))
    # the depthwise taps and the projection's columns sum to zero, so that
    # their products of the positive ReLU6 outputs stay centred and the
    # fast variances of h2 and h3 do not cancel in f32 (at 960 hidden
    # channels they otherwise lose their last digits)
    wd = rng.standard_normal((3, 3, ch)) / 3
    wp = rng.standard_normal((ch, cout)) / np.sqrt(ch)
    weights = [t(rng.standard_normal((cin, ch)) / np.sqrt(cin)),
               t(wd - wd.mean((0, 1))), t(wp - wp.mean(0))]
    for c, bias in ((ch, rng.uniform(1, 2, ch)), (ch, rng.uniform(1, 2, ch)),
                    (cout, 0.1 * rng.standard_normal(cout))):
        weights += [t(rng.uniform(0.5, 1.5, c), torch.float32),
                    t(bias, torch.float32)]
    dy = t(rng.standard_normal((b, h, w, cout)))
    return x, tuple(weights), dy


def _close(got, ref, tol, scale=None):
    if scale is None:
        scale = float(ref.float().abs().max()) or 1.0
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * scale, f"max err {err} vs {tol} * {scale}"


def _grad_errors(grads, ref):
    """Per gradient, the largest |difference| over the larger of its own
    largest |value| and 1e-3 of the largest of the ten."""
    gmax = max(float(r.float().abs().max()) for r in ref)
    return [float((a.float() - r.float()).abs().max())
            / max(float(r.float().abs().max()), 1e-3 * gmax)
            for a, r in zip(grads, ref)]


def _grad_tolerances(x, dy, weights, args, ref, tol):
    """``tol`` per gradient; in bf16 at least twice the plain version's own
    distance from its f32 result on the same inputs."""
    if x.dtype == torch.float32:
        return [tol] * len(ref)
    f32 = fused_ir.fused_bwd_plain(x.float(), dy.float(),
                                   tuple(t.float() for t in weights), *args)
    return [max(tol, 2 * e) for e in _grad_errors(ref, f32)]


def _check_grads(grads, ref, tols):
    errs = _grad_errors(grads, ref)
    assert all(e <= t for e, t in zip(errs, tols)), list(zip(errs, tols))
    # the judge refuses a zeroed dx
    zeroed = _grad_errors([torch.zeros_like(grads[0]), *grads[1:]], ref)
    assert zeroed[0] > tols[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions_on_card(shape, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, cin, cout, d, g = shape
    x, weights, dy = _inputs(b, h, w, cin, cout, dtype)
    use_res = cin == cout
    fused_ir.reset_launch_counts()
    y, stats, state = fused_ir.fused_fwd_kernel(x, weights, g, d, use_res)
    grads = fused_ir.fused_bwd_kernel(x, dy, weights, g, d, use_res,
                                      state=state)
    torch.cuda.synchronize()
    assert fused_ir.launch_counts["fused_fwd"] == 1
    assert fused_ir.launch_counts["fused_bwd"] == 1
    y_ref, stats_ref = fused_ir.fused_fwd_plain(x, weights, g, d, use_res)
    grads_ref = fused_ir.fused_bwd_plain(x, dy, weights, g, d, use_res)
    _close(y, y_ref, tol)
    for a, r in zip(stats, stats_ref):
        _close(a, r, 1e-5 if dtype == torch.float32 else tol)
    _check_grads(grads, grads_ref, _grad_tolerances(
        x, dy, weights, (g, d, use_res), grads_ref, tol))
    # two calls give bit-equal results: no float atomics
    y2, _, _ = fused_ir.fused_fwd_kernel(x, weights, g, d, use_res)
    grads2 = fused_ir.fused_bwd_kernel(x, dy, weights, g, d, use_res,
                                       state=state)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b2) for a, b2 in zip(grads, grads2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 23, 30, 64, 64, 1, 4),
                                   (1, 5, 6, 200, 40, 2, 1)])
def test_forward_repeats_bit_equal(shape, dtype, monkeypatch):
    """Two forward calls give the same y, moments and saved state, bit for
    bit: every sum is taken in a fixed order, with no float atomics. The
    shapes split a product over its depth (the project; the expand). The
    workspaces are zeroed first, so that the alignment gaps between the
    state's pieces, which no kernel writes, compare equal too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    workspace = fused_ir._workspace
    monkeypatch.setattr(fused_ir, "_workspace",
                        lambda dims, which, device:
                        workspace(dims, which, device).zero_())
    b, h, w, cin, cout, d, g = shape
    x, weights, _ = _inputs(b, h, w, cin, cout, dtype, seed=4)
    (y, stats, state), (y2, stats2, state2) = [
        fused_ir.fused_fwd_kernel(x, weights, g, d, cin == cout)
        for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b2) for a, b2 in zip(stats, stats2))
    assert torch.equal(state.work, state2.work)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 4e-2)])
def test_kernels_take_half_the_gradient_at_ties(dtype, tol):
    """Exact 0 and 6 after BN + ReLU6 and a zero variance (the construction
    of tests/test_torch_fused_ir.py's tie case): hidden channels 0 and 1
    copy input channel 0, which is +-1 with mean exactly 0, so the padded
    border normalises to exactly beta (0 and 6); hidden channels 2 and 3
    have zero depthwise taps, so they are constant. The kernels' masks must
    give what the plain version's min/max give; in f32 each gradient is
    held to its own largest |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, h, w, c, g = 8, 9, 10, 16, 4
    x, weights, dy = _inputs(b, h, w, c, c, torch.float32, seed=5)
    rng = np.random.default_rng(5)
    signs = np.repeat([1.0, -1.0], g * h * w // 2)
    x[..., 0] = torch.from_numpy(np.concatenate(
        [rng.permutation(signs) for _ in range(b // g)]).reshape(b, h, w)
        .astype(np.float32)).to(x.device)
    we, wd, wp, g1, b1, g2, b2, g3, b3 = [t.clone() for t in weights]
    we[:, :2] = 0.0
    we[0, :2] = 1.0
    b1[0], b1[1] = 0.0, 6.0
    wd[:, :, :2] = torch.tensor([[0.5, -0.5, 0.25], [-0.25, 0.0, 0.75],
                                 [-0.75, 0.125, -0.125]],
                                device=wd.device)[..., None]
    wd[:, :, 2:4] = 0.0
    b2[2], b2[3] = 6.0, 0.0
    x, dy = x.to(dtype), dy.to(dtype)
    weights = (we.to(dtype), wd.to(dtype), wp.to(dtype), g1, b1, g2, b2, g3,
               b3)
    y, stats, state = fused_ir.fused_fwd_kernel(x, weights, g, 1, True)
    grads = fused_ir.fused_bwd_kernel(x, dy, weights, g, 1, True,
                                      state=state)
    y_ref, stats_ref = fused_ir.fused_fwd_plain(x, weights, g, 1, True)
    grads_ref = fused_ir.fused_bwd_plain(x, dy, weights, g, 1, True)
    assert float(stats_ref[3][:, 2:4].abs().max()) == 0.0
    _close(y, y_ref, tol)
    _check_grads(grads, grads_ref, _grad_tolerances(
        x, dy, weights, (g, 1, True), grads_ref, tol))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take():
    """A CUDA tensor reaches a kernel or an error, never the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, weights, _ = _inputs(4, 5, 6, 8, 8, torch.float32)
    fused_ir.reset_launch_counts()
    with pytest.raises(TypeError):
        fused_ir.fused_fwd_kernel(x.half(), weights, 4, 1, True)
    with pytest.raises(ValueError, match="group"):
        fused_ir.fused_fwd_kernel(x, weights, 3, 1, True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ir.fused_fwd_kernel(x.transpose(1, 2).contiguous()
                                  .transpose(1, 2), weights, 4, 1, True)
    # a dilation whose depthwise halo tile outgrows shared memory
    with pytest.raises(ValueError, match="refuse"):
        fused_ir.fused_fwd_kernel(x, weights, 4, 16, True)
    assert fused_ir.launch_counts["fused_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_leaves_the_saved_state_unchanged(dtype):
    """The backward only reads what the forward left: the workspace's and
    the moments' bytes are the same after two backward calls, and the two
    calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, weights, dy = _inputs(8, 11, 13, 24, 24, dtype, seed=3)
    _, stats, state = fused_ir.fused_fwd_kernel(x, weights, 4, 2, True)
    work = state.work.clone()
    moments = [t.clone() for t in stats]
    grads = fused_ir.fused_bwd_kernel(x, dy, weights, 4, 2, True,
                                      state=state)
    grads2 = fused_ir.fused_bwd_kernel(x, dy, weights, 4, 2, True,
                                       state=state)
    torch.cuda.synchronize()
    assert torch.equal(work, state.work)
    assert all(torch.equal(a, b) for a, b in zip(moments, state.stats))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_backward_kernel_needs_the_saved_state():
    """Without the forward's state the backward raises: it never
    recomputes the forward behind the caller's back. A state of other
    dims is refused too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, weights, dy = _inputs(4, 5, 6, 16, 16, torch.float32)
    fused_ir.reset_launch_counts()
    with pytest.raises(ValueError, match="saved state"):
        fused_ir.fused_bwd_kernel(x, dy, weights, 4, 1, True)
    _, _, other = fused_ir.fused_fwd_kernel(x, weights, 2, 1, True)
    with pytest.raises(ValueError, match="saved state"):
        fused_ir.fused_bwd_kernel(x, dy, weights, 4, 1, True, state=other)
    assert fused_ir.launch_counts["fused_bwd"] == 0


@pytest.mark.cuda
def test_autograd_keeps_the_state_only_for_a_gradient():
    """``fused_ir_block`` keeps the forward's workspace for the backward
    when a gradient can be taken, and its gradients match the kernels
    called directly; under ``torch.no_grad()`` nothing is kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, weights, dy = _inputs(4, 9, 10, 16, 16, torch.float32, seed=2)
    leaves = [t.clone().requires_grad_() for t in (x, *weights)]
    y, _ = fused_ir.fused_ir_block(*leaves, 4, 1, True)
    (y * dy).sum().backward()
    _, _, state = fused_ir.fused_fwd_kernel(x, weights, 4, 1, True)
    ref = fused_ir.fused_bwd_kernel(x, dy, weights, 4, 1, True, state=state)
    assert all(torch.equal(t.grad, r) for t, r in zip(leaves, ref))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        y, stats = fused_ir.fused_ir_block(*leaves, 4, 1, True)
    held = y.numel() * 4 + sum(t.numel() * 4 for t in stats)
    assert torch.cuda.memory_allocated() - before <= held + 4096
