"""Fused inverted-residual block: the hand-written Hopper kernels and their
plain versions.

Counterpart of ``pixelpick_tpu/ops/fused_ir.py``. The TPU kernels
``_fwd_kernel`` and ``_bwd_kernel`` become ``csrc/fused_ir.cu``
(``pp_fused_ir_fwd`` and ``pp_fused_ir_bwd``, CUDA C++ for ``sm_90a``; the
note at the top of that file says how they are laid out and what bounds
them), built by ``ops/build.py``.

One stride-1, expand-ratio-6 MobileNetV2 block in train mode, per ghost-BN
group of ``group`` images: zero-pad by the dilation, expand 1x1, BN on the
group's moments, ReLU6, depthwise 3x3, BN, ReLU6, project 1x1, BN, plus x
when in == out. It returns y and six (B // group, C) f32 moment arrays for
the caller's running-stat EMA; their gradients are ignored.

- :func:`block_fwd_math` and :func:`staged_vjp` are the plain PyTorch
  versions, over ONE group, op for op as the JAX functions (the compute
  dtype is ``we.dtype``; casts where JAX casts; ReLU6 as min/max, whose
  gradient is 0.5 at exactly 0 and 6, as JAX's).
- :func:`fused_ir_block` is a ``torch.autograd.Function``. On a CUDA
  tensor it keeps what the forward kernel wrote (h1, h2, h3 and each
  stage's statistics: :class:`FusedState`) and the backward kernel reads
  it; the TPU kernel recomputes the forward instead, because a group's
  hidden tensors do not fit twice in VMEM. A CPU tensor takes the plain
  versions, whose backward recomputes from x; a CUDA tensor launches the
  kernels or raises.

The TPU package gates the fused path on a VMEM estimate
(``vmem_estimate_bytes``). The port needs no gate: every phase of
``csrc/fused_ir.cu`` walks its operands through shared-memory tiles of a
fixed number of pixels, whatever the block's size, and the kernels refuse
only shapes that do not form a block (``_check``), and dilations above 15
or hidden widths above 8192, whose tiles would outgrow an SM's shared
memory (``pp_fused_ir_workspace`` returns 0 for both).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pixelpick_tpu_torch.ops.build import load_library

EPS = 1e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the two kernels.
launch_counts = {"fused_fwd": 0, "fused_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------- plain versions -----------------------------

def _relu6(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    return torch.minimum(torch.maximum(xf, zero), zero + 6.0).to(x.dtype)


def _moments(h: torch.Tensor):
    """Fast-variance f32 moments over (batch, H, W), clamped at 0 with a
    max whose gradient is 0.5 at a tie, as ``jnp.maximum``'s."""
    hf = h.float()
    mu = hf.mean((0, 1, 2))
    mu2 = (hf * hf).mean((0, 1, 2))
    var = torch.maximum(torch.zeros((), device=hf.device), mu2 - mu * mu)
    return mu, var


def _bn(h, mu, var, scale, bias, dtype):
    mul = torch.rsqrt(var + EPS) * scale
    return ((h.float() - mu) * mul + bias).to(dtype)


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N, K] x [K, M] in f32 (bf16 products are exact in f32), the result
    in the compute dtype: ``jnp.dot(..., preferred_element_type=f32)``
    followed by the cast."""
    return (a.float() @ w.float()).to(w.dtype)


def stage1_pre(x, we, g1, b1, dilation: int):
    """pad -> expand 1x1 -> BN(group): the input of the first ReLU6 over
    the padded domain, and the moments."""
    cdtype = we.dtype
    d = dilation
    xp = F.pad(x.to(cdtype), (0, 0, d, d, d, d))
    grp, hp, wpad, cin = xp.shape
    h1 = _matmul(xp.reshape(-1, cin), we).reshape(grp, hp, wpad, -1)
    mu1, var1 = _moments(h1)
    return _bn(h1, mu1, var1, g1, b1, cdtype), mu1, var1


def _stage1(x, we, g1, b1, dilation: int):
    """pad -> expand 1x1 -> BN(group) -> relu6."""
    u1, mu1, var1 = stage1_pre(x, we, g1, b1, dilation)
    return _relu6(u1), mu1, var1


def stage2_pre(a1, wd, g2, b2, dilation: int):
    """depthwise 3x3 (9 taps, f32) -> BN(group): the input of the second
    ReLU6, and the moments."""
    cdtype = a1.dtype
    d = dilation
    hh, ww = a1.shape[1] - 2 * d, a1.shape[2] - 2 * d
    acc = None
    for ky in range(3):
        for kx in range(3):
            t = a1[:, ky * d:ky * d + hh, kx * d:kx * d + ww, :].float() \
                * wd[ky, kx].float()
            acc = t if acc is None else acc + t
    h2 = acc.to(cdtype)
    mu2, var2 = _moments(h2)
    return _bn(h2, mu2, var2, g2, b2, cdtype), mu2, var2


def _stage2(a1, wd, g2, b2, dilation: int):
    """depthwise 3x3 (9 taps, f32) -> BN(group) -> relu6."""
    u2, mu2, var2 = stage2_pre(a1, wd, g2, b2, dilation)
    return _relu6(u2), mu2, var2


def _stage3(a2, wp, g3, b3, x, use_res: bool):
    """project 1x1 -> BN(group) -> (+x)."""
    cdtype = a2.dtype
    grp, hh, ww, ch = a2.shape
    h3 = _matmul(a2.reshape(-1, ch), wp).reshape(grp, hh, ww, -1)
    mu3, var3 = _moments(h3)
    out = _bn(h3, mu3, var3, g3, b3, cdtype)
    y = x.to(cdtype) + out if use_res else out
    return y, mu3, var3


def block_fwd_math(x, we, wd, wp, g1, b1, g2, b2, g3, b3,
                   dilation: int, use_res: bool):
    """The plain forward of one block over ONE BN group.

    x: (G, H, W, Cin); we: (Cin, Ch); wd: (3, 3, Ch); wp: (Ch, Cout); BN
    scale/bias f32. Returns (y, (mu1, var1, mu2, var2, mu3, var3))."""
    a1, mu1, var1 = _stage1(x, we, g1, b1, dilation)
    a2, mu2, var2 = _stage2(a1, wd, g2, b2, dilation)
    y, mu3, var3 = _stage3(a2, wp, g3, b3, x, use_res)
    return y, (mu1, var1, mu2, var2, mu3, var3)


def staged_vjp(x, dy, weights, dilation: int, use_res: bool):
    """The plain backward of one group, stage by stage as the JAX
    ``_staged_vjp``: each stage's forward is recomputed inside its own
    vector-Jacobian product. Returns (dx, dwe, dwd, dwp, dg1, db1, dg2, db2,
    dg3, db3), each in its input's dtype."""
    we, wd, wp, g1, b1, g2, b2, g3, b3 = weights

    def leaves(*ts):
        return [t.detach().requires_grad_(True) for t in ts]

    def vjp(fn, inputs, cot):
        with torch.enable_grad():
            out = fn(*inputs)
            grads = torch.autograd.grad(out, inputs, cot, allow_unused=True)
        return [torch.zeros_like(t) if gr is None else gr
                for t, gr in zip(inputs, grads)]

    with torch.no_grad():
        a1 = _stage1(x, we, g1, b1, dilation)[0]
        a2 = _stage2(a1, wd, g2, b2, dilation)[0]
    da2, dwp, dg3, db3, dx_res = vjp(
        lambda a2_, wp_, g3_, b3_, x_: _stage3(a2_, wp_, g3_, b3_, x_,
                                               use_res)[0],
        leaves(a2, wp, g3, b3, x), dy)
    da1, dwd, dg2, db2 = vjp(
        lambda a1_, wd_, g2_, b2_: _stage2(a1_, wd_, g2_, b2_, dilation)[0],
        leaves(a1, wd, g2, b2), da2)
    dx, dwe, dg1, db1 = vjp(
        lambda x_, we_, g1_, b1_: _stage1(x_, we_, g1_, b1_, dilation)[0],
        leaves(x, we, g1, b1), da1)
    dx = dx + dx_res.to(dx.dtype)
    return dx, dwe, dwd, dwp, dg1, db1, dg2, db2, dg3, db3


def fused_fwd_plain(x, weights, group: int, dilation: int, use_res: bool):
    """The plain version of the forward kernel over the whole batch: y and
    the six (B // group, C) moment arrays."""
    ys, stats = [], []
    for i in range(x.shape[0] // group):
        y, s = block_fwd_math(x[i * group:(i + 1) * group], *weights,
                              dilation, use_res)
        ys.append(y)
        stats.append(s)
    return torch.cat(ys), tuple(torch.stack(col) for col in zip(*stats))


def fused_bwd_plain(x, dy, weights, group: int, dilation: int,
                    use_res: bool):
    """The plain version of the backward kernel: dx per group, the nine
    parameter gradients summed over groups in f32, then cast to their
    weights' dtype (``_fused_ir_bwd``)."""
    dxs, acc = [], None
    for i in range(x.shape[0] // group):
        sl = slice(i * group, (i + 1) * group)
        g = staged_vjp(x[sl], dy[sl], weights, dilation, use_res)
        dxs.append(g[0])
        acc = [v.float() for v in g[1:]] if acc is None \
            else [a + v.float() for a, v in zip(acc, g[1:])]
    return (torch.cat(dxs),) + tuple(a.to(w.dtype)
                                     for a, w in zip(acc, weights))


# ----------------------------- the kernels -----------------------------

def _library():
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    return load_library("fused_ir", {
        "pp_fused_ir_workspace": ([ints, ctypes.c_int], ctypes.c_size_t),
        "pp_fused_ir_fwd": ([ptrs, ints, ctypes.c_void_p], ctypes.c_int),
        "pp_fused_ir_bwd": ([ptrs, ints, ctypes.c_void_p], ctypes.c_int),
    })


def _check_config(x, cout: int, group: int, dilation: int,
                  use_res: bool) -> None:
    if (group < 1 or x.shape[0] % group or dilation < 1
            or (use_res and x.shape[-1] != cout)):
        raise ValueError(f"bad group {group} / dilation {dilation} / "
                         f"use_res {use_res} for x {tuple(x.shape)}")


def _check(x, weights, group, dilation, use_res):
    we, wd, wp, *bn = weights
    if x.device.type != "cuda":
        raise ValueError(f"the fused block kernels run on CUDA tensors, got "
                         f"{x.device}")
    if we.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused block kernels take float32 or bfloat16, "
                        f"got {we.dtype}")
    for t in (x, wd, wp):
        if t.dtype != we.dtype or t.device != x.device:
            raise TypeError(f"x, we, wd and wp must share dtype and device; "
                            f"got {t.dtype} on {t.device}")
    for t in bn:
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError("the BatchNorm vectors must be float32 on the "
                            "device of x")
    b, h, w, cin = x.shape
    ch, cout = we.shape[1], wp.shape[1]
    if (tuple(we.shape) != (cin, ch) or tuple(wd.shape) != (3, 3, ch)
            or tuple(wp.shape) != (ch, cout)
            or [tuple(t.shape) for t in bn] != [(ch,)] * 4 + [(cout,)] * 2):
        raise ValueError(f"shapes do not form a block: x {tuple(x.shape)}, "
                         f"we {tuple(we.shape)}, wd {tuple(wd.shape)}, wp "
                         f"{tuple(wp.shape)}")
    _check_config(x, cout, group, dilation, use_res)
    if not all(t.is_contiguous() for t in (x, *weights)):
        raise ValueError("the fused block kernels take contiguous tensors")
    return [_DTYPE_CODES[we.dtype], b, h, w, cin, ch, cout, group, dilation,
            int(use_res)]


def _workspace(dims, which: int, device) -> torch.Tensor:
    """Scratch for a kernel call: ``which`` 0 is the forward's workspace
    (the state it leaves for the backward), 1 the backward's, 2 the
    forward's transient scratch (a product's depth-split sums)."""
    nbytes = _library().pp_fused_ir_workspace(
        (ctypes.c_int * len(dims))(*dims), which)
    if nbytes == 0:
        raise ValueError(f"the fused block kernels refuse dims {dims}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _call(fn_name: str, tensors, dims) -> None:
    lib = _library()
    dims_c = (ctypes.c_int * len(dims))(*dims)
    device = tensors[0].device
    ptrs = [t.data_ptr() for t in tensors]
    ptrs_c = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(ptrs_c, dims_c, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} for "
                           f"dims {dims}")


class FusedState(NamedTuple):
    """What a forward kernel call leaves for the backward: its workspace
    (h1 over the padded domain, h2 and h3 in the compute dtype, and each
    stage's BatchNorm mul and tie factor), the six moments it returned, and
    the dims it ran at. The backward only reads it."""
    work: torch.Tensor
    stats: Tuple[torch.Tensor, ...]
    dims: list


def fused_fwd_kernel(x, weights, group: int, dilation: int, use_res: bool):
    """Launch ``pp_fused_ir_fwd``: y, the six moment arrays and the
    :class:`FusedState` that the backward kernel reads. A caller that
    takes no gradient drops the state, and its workspace is freed."""
    dims = _check(x, weights, group, dilation, use_res)
    b, h, w, _ = x.shape
    ch, cout = weights[0].shape[1], weights[2].shape[1]
    ng = b // group
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    stats = tuple(torch.empty((ng, c), dtype=torch.float32, device=x.device)
                  for c in (ch, ch, ch, ch, cout, cout))
    work = _workspace(dims, 0, x.device)
    scratch = _workspace(dims, 2, x.device)
    _call("pp_fused_ir_fwd", [x, *weights, y, *stats, work, scratch], dims)
    launch_counts["fused_fwd"] += 1
    return y, stats, FusedState(work, stats, dims)


def fused_bwd_kernel(x, dy, weights, group: int, dilation: int,
                     use_res: bool, state: FusedState = None):
    """Launch ``pp_fused_ir_bwd`` on the ``state`` that the forward kernel
    left for the same x and weights: dx and the nine gradients, the weight
    gradients cast to their weights' dtype as ``_fused_ir_bwd`` does.
    Raises without a state: the kernel never recomputes the forward."""
    dims = _check(x, weights, group, dilation, use_res)
    if dy.shape[:3] != x.shape[:3] or dy.dtype != x.dtype \
            or not dy.is_contiguous():
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match")
    if state is None:
        raise ValueError("the backward kernel reads the saved state that "
                         "fused_fwd_kernel returns; none was given")
    if state.dims != dims or state.work.device != x.device:
        raise ValueError(f"the saved state is of dims {state.dims}, the "
                         f"backward's are {dims}")
    dx = torch.empty_like(x)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=x.device)
             for t in weights]
    work = _workspace(dims, 1, x.device)
    _call("pp_fused_ir_bwd", [x, dy, *weights, dx, *grads, *state.stats,
                              state.work, work], dims)
    launch_counts["fused_bwd"] += 1
    return (dx,) + tuple(g.to(w.dtype) for g, w in zip(grads, weights))


class _FusedIR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, we, wd, wp, g1, b1, g2, b2, g3, b3, group, dilation,
                use_res):
        weights = tuple(t.contiguous() for t in (we, wd, wp, g1, b1, g2, b2,
                                                  g3, b3))
        x = x.contiguous()
        _check_config(x, wp.shape[1], group, dilation, use_res)
        work = dims = None
        if x.device.type == "cpu":
            with torch.no_grad():
                y, stats = fused_fwd_plain(x, weights, group, dilation,
                                           use_res)
        else:
            y, stats, (work, _, dims) = fused_fwd_kernel(
                x, weights, group, dilation, use_res)
        # Autograd drops what is saved when no gradient can be taken, and
        # the workspace is then freed on return.
        ctx.save_for_backward(x, *weights, *stats, work)
        ctx.cfg = (group, dilation, use_res)
        ctx.dims = dims
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, *_stat_cotangents):
        saved = ctx.saved_tensors
        x, weights, stats, work = saved[0], saved[1:10], saved[10:16], \
            saved[16]
        dy = dy.contiguous()
        if x.device.type == "cpu":
            grads = fused_bwd_plain(x, dy, weights, *ctx.cfg)
        else:
            grads = fused_bwd_kernel(x, dy, weights, *ctx.cfg,
                                     state=FusedState(work, stats, ctx.dims))
        return (*grads, None, None, None)


def fused_ir_block(x, we, wd, wp, g1, b1, g2, b2, g3, b3, group: int,
                   dilation: int, use_res: bool):
    """Fused block, NHWC. x: (B, H, W, Cin) with B % group == 0; weights in
    the compute dtype, BN vectors f32. Returns (y, (mu1, var1, mu2, var2,
    mu3, var3)), the moments (B // group, C) f32 and not differentiable.
    On a CUDA tensor the forward kernel's state is kept for the backward
    while a gradient can be taken, and freed on return otherwise."""
    y, *stats = _FusedIR.apply(x, we, wd, wp, g1, b1, g2, b2, g3, b3, group,
                               dilation, use_res)
    return y, tuple(stats)


def block_flops(b: int, h: int, w: int, cin: int, ch: int, cout: int,
                dilation: int) -> Tuple[int, int]:
    """(forward, backward) operations of one block call: the expand over
    the padded domain, 9 multiply-adds per hidden value, the project. The
    backward reads h1, h2 and h3 from the forward's saved state instead of
    recomputing them, and does twice the forward's work: each product's
    data gradient and weight gradient, the depthwise's two."""
    hp, wp = h + 2 * dilation, w + 2 * dilation
    fwd = 2 * b * hp * wp * cin * ch + 18 * b * h * w * ch \
        + 2 * b * h * w * ch * cout
    return fwd, 2 * fwd
