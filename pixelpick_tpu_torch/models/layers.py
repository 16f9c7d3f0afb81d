"""Shared building blocks.

Counterpart of ``pixelpick_tpu/models/layers.py``. Modules
take and return NCHW tensors in ``torch.channels_last`` memory format, so
``x.permute(0, 2, 3, 1)`` is a free, contiguous NHWC view (the layout of the
JAX package and of the depthwise kernel) and cuDNN convolutions read the
same memory with no transposes.

Parameters and BatchNorm statistics stay f32; each conv casts its input and
weight to the compute ``dtype`` and BatchNorm casts its output to it, as the
JAX modules do (``layers.py:81-83``, ``:134-136``, ``:304-318``). Under data
parallelism (``parallel/mesh.py``) the train-mode BatchNorm groups and the
dropout draws are the global batch's. Under a height shard
(``--spatial_query_sharding``, eval only) every op that pads rows takes
them from ``parallel/halo.py`` and runs VALID in height, and the dropout
masks are the whole map's, sliced to the rank's rows. Parameter
and buffer names follow the reference's torch modules (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``).

Train mode: BatchNorm is the JAX package's ghost BN (``ghost_bn_train``,
``_BNCore``), not ``nn.BatchNorm2d``, whose running variance is the unbiased
one. ReLU6 is ``min(max(x, 0), 6)``, whose gradient is 0.5 at exactly 0 and
6, as JAX's (``torch.clamp`` gives 1 and ``F.relu6`` 0 there). The dropouts
draw from an explicit ``torch.Generator`` when one is set.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from pixelpick_tpu_torch.ops.depthwise import depthwise_conv3x3
from pixelpick_tpu_torch.parallel import distributed, halo, mesh


def he_normal_fan_in_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """torch kaiming_normal_ (fan_in, a=0) == flax He normal fan_in
    (``layers.py:17``), drawn from an explicit generator."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


def group_size(groups: int, b: int) -> int:
    """The ghost-BN group of a batch of ``b`` rows: ``groups``, or the whole
    batch when it does not divide it."""
    return groups if 0 < groups < b and b % groups == 0 else b


def row_groups(x: torch.Tensor, groups: int):
    """The ghost-BN groups of ``x``'s rows: (g, each row's group among those
    :func:`ghost_bn_train` returns moments for, whether every group lies
    within this rank's rows). Under a row shard (``parallel/mesh.py``) the
    groups are the global batch's."""
    shard = mesh.current_shard()
    lo, b = (0, x.shape[0]) if shard is None else (shard.lo, shard.rows)
    g = group_size(groups, b)
    group = torch.arange(lo, lo + x.shape[0], device=x.device) // g
    local = shard is None or (x.shape[0] % g == 0 and lo % g == 0)
    return g, (group - lo // g if local else group), local


def ghost_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, dtype, count=None):
    """Train-mode (ghost) BatchNorm of NCHW ``x`` (``layers.py:22-38``):
    contiguous groups of ``groups`` samples, or the whole batch when
    ``groups`` does not divide it; f32 fast variance max(0, E[x^2] -
    E[x]^2). Returns (y in ``dtype``, mu, var) with mu/var (n_groups, C)
    f32. ``count``: the pixels per sample the sums are divided by, in place
    of H*W (the s2d BatchNorm's padded map, ``models/s2d_block.py``).

    Under a row shard (``parallel/mesh.py:sharded``) ``x`` is this rank's
    rows of the global batch, and the groups are the global batch's, as
    JAX traces the global shape. A group within the rank's rows is
    computed here, with no collective, and mu/var are the rank's groups;
    groups that span ranks take their sums of x and x^2 from a
    differentiable all-reduce (its backward reduces the gradient terms as
    well), and mu/var are every group's."""
    g, group, local = row_groups(x, groups)
    xf = x.float()
    if local:
        xg = xf.reshape(x.shape[0] // g, g, *x.shape[1:])
        if count is None:
            mu = xg.mean((1, 3, 4))
            mu2 = (xg * xg).mean((1, 3, 4))
        else:
            mu = xg.sum((1, 3, 4)) / (g * count)
            mu2 = (xg * xg).sum((1, 3, 4)) / (g * count)
    else:
        # each row's f32 sums, added across rows and ranks in f64, so that
        # the moments round once, as the local groups' means do
        b = mesh.current_shard().rows
        rows = torch.stack([xf.sum((2, 3)), (xf * xf).sum((2, 3))], 1)
        sums = torch.zeros((b // g, 2, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add(0, group, rows.double())
        per = x.shape[2] * x.shape[3] if count is None else count
        sums = dist_nn.all_reduce(sums) / (g * per)
        mu, mu2 = sums[:, 0].float(), sums[:, 1].float()
    var = torch.maximum(torch.zeros((), device=x.device), mu2 - mu * mu)
    mul = (torch.rsqrt(var + eps) * scale)[group][..., None, None]
    y = (xf - mu[group][..., None, None]) * mul + bias.view(1, -1, 1, 1)
    return y.to(dtype), mu, var


_STATS_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode BatchNorms in this thread leave their running statistics
    alone: the recompute of a rematerialised block (``MobileNetV2``'s
    ``remat_blocks``) runs its BatchNorms a second time, and flax's
    ``nn.checkpoint`` applies their EMA once."""
    before = getattr(_STATS_FROZEN, "on", False)
    _STATS_FROZEN.on = True
    try:
        yield
    finally:
        _STATS_FROZEN.on = before


def refuse_height_shard() -> None:
    """Raise where a train-mode BatchNorm runs under a height shard."""
    if mesh.current_height_shard() is not None:
        raise RuntimeError("a height shard runs the eval-mode sweep only; "
                           "train-mode BatchNorm refuses it")


class BatchNorm(nn.Module):
    """BatchNorm2d with the JAX package's arithmetic. Eval:
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, cast to the
    compute dtype (``layers.py:80-83``). Train: ghost BN over groups of
    ``groups`` samples (0 = the whole batch) and the running-stat EMA over
    the group-mean of the biased variances, momentum 0.9 (``_BNCore``,
    ``layers.py:85-91``). Init: scale 1, bias 0, mean 0, var 1."""

    def __init__(self, num_features: int, dtype=torch.float32,
                 eps: float = 1e-5, groups: int = 0):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    @torch.no_grad()
    def update_running_stats(self, mu: torch.Tensor, var: torch.Tensor,
                             momentum: float = 0.9) -> None:
        """EMA of the group-mean moments, as ``_BNCore``/``FusedIRBlock._ema``.
        Under a row shard whose groups lie within the ranks, ``mu``/``var``
        are this rank's groups: their means are averaged over the ranks, so
        every rank keeps the same statistics. A no-op inside
        :func:`frozen_running_stats`."""
        if getattr(_STATS_FROZEN, "on", False):
            return
        m, v = mu.mean(0), var.mean(0)
        shard = mesh.current_shard()
        if shard is not None and mu.shape[0] \
                < shard.rows // group_size(self.groups, shard.rows):
            m, v = mesh.reduce_sum(torch.stack([m, v])) \
                / distributed.world_size()
        self.running_mean.copy_(momentum * self.running_mean
                                + (1 - momentum) * m)
        self.running_var.copy_(momentum * self.running_var
                               + (1 - momentum) * v)
        self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            refuse_height_shard()
            y, mu, var = ghost_bn_train(x, self.weight, self.bias,
                                        self.groups, self.eps, self.dtype)
            self.update_running_stats(mu.detach(), var.detach())
            return y
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)
        return y.to(self.dtype)


def relu6(x: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 6)


class ReLU6(nn.Module):
    """``min(max(x, 0), 6)``: the JAX package's ``relu6`` and its gradient."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(x)


class Dropout(nn.Module):
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    1 - p and scale by 1 / (1 - p); identity when inactive or at p = 0.
    It is active in train mode, or where the caller passes ``active=True``
    (the MC-dropout committee scores in eval mode with its dropouts on).
    ``broadcast_hw`` drops whole feature maps (``Dropout2d``). The mask is
    drawn from ``self.generator`` (set by ``DeepLab.set_dropout_generator``)
    or, when none is set, from torch's default generator."""

    def __init__(self, p: float, broadcast_hw: bool = False):
        super().__init__()
        self.p = p
        self.broadcast_hw = broadcast_hw
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor,
                active: Optional[bool] = None) -> torch.Tensor:
        if not (self.training if active is None else active) or self.p == 0:
            return x
        shape = (*x.shape[:2], 1, 1) if self.broadcast_hw else x.shape
        # the global batch's draw (the whole map's under a height shard),
        # sliced to this rank's rows
        u = mesh.rand_rows(shape, self.generator, x.device,
                           height_axis=None if self.broadcast_hw else 2)
        keep = u < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class Dropout2d(Dropout):
    """Channel dropout, torch ``nn.Dropout2d`` (``layers.py:415-423``)."""

    def __init__(self, p: float):
        super().__init__(p, broadcast_hw=True)


class Conv1x1(nn.Module):
    """1x1 convolution as a channel matmul on the NHWC view
    (``layers.py:113-141``). Weight ``(O, I, 1, 1)``, as ``nn.Conv2d``."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.permute(0, 2, 3, 1).to(self.dtype),
                     self.weight[:, :, 0, 0].to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.permute(0, 3, 1, 2)


class Conv2d(nn.Module):
    """General convolution through the library (cuDNN on the card), the
    counterpart of the JAX package's ``nn.Conv`` / ``lax.conv`` path."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x, (pad_h, _) = halo.pad_rows(x, (self.weight.shape[2] - 1)
                                      * self.dilation + 1, self.stride,
                                      self.padding)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, (pad_h, self.padding), self.dilation,
                        self.groups)


class PallasDepthwise(nn.Module):
    """3x3 depthwise conv (padding 0: the block input is already padded)
    backed by ``ops/depthwise.py`` — the hand-written kernel at stride 1,
    the grouped conv at stride 2 (``layers.py:366-388``). Weight
    ``(C, 1, 3, 3)``, as the grouped ``nn.Conv2d``; the class keeps the JAX
    module's name, as the flag does."""

    def __init__(self, features: int, stride: int = 1, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(features, 1, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, 0].permute(1, 2, 0).to(self.dtype).contiguous()
        # a no-op copy for channels_last input, which the model keeps
        xh = x.to(self.dtype).permute(0, 2, 3, 1).contiguous()
        y = depthwise_conv3x3(xh, w, self.stride, self.dilation, 0)
        return y.permute(0, 3, 1, 2)


def _taps(x: torch.Tensor, d: int, pad_h: int):
    """The 9 windows of a 3x3 conv at dilation ``d`` over the NHWC ``x``,
    zero-padded by ``d`` columns and ``pad_h`` rows on each side (``d``:
    same-shape; 0: rows already padded, ``halo.pad_rows``): (ky, kx,
    (B, H_out, W, C) view of the padded input)."""
    xp = F.pad(x, (0, 0, d, d, pad_h, pad_h))
    h, w = xp.shape[1] - 2 * d, x.shape[2]
    return [(ky, kx, xp[:, ky * d:ky * d + h, kx * d:kx * d + w])
            for ky in range(3) for kx in range(3)]


class Conv3x3MatMul(Conv2d):
    """Same-shape 3x3 conv (stride 1, padding == dilation) as 9 shifted
    channel matmuls on the NHWC view, accumulated in f32
    (``layers.py:144-191``, ``--conv3x3_matmul``). Weight ``(O, I, 3, 3)``
    and bias as ``nn.Conv2d``, so the weight bridge is unchanged. In bf16
    each tap's product of bf16 values is taken in f32, as JAX's
    ``preferred_element_type=jnp.float32``."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 bias: bool = False, dtype=torch.float32):
        super().__init__(in_ch, out_ch, 3, 1, dilation, dilation, 1, bias,
                         dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x.permute(0, 2, 3, 1).to(self.dtype).float()
        xh, (pad_h, _) = halo.pad_rows(xh, 2 * self.dilation + 1, 1,
                                       self.dilation, axis=1)
        k = self.weight.to(self.dtype).float()
        acc = None
        for ky, kx, win in _taps(xh, self.dilation, pad_h):
            term = torch.matmul(win, k[:, :, ky, kx].t())
            acc = term if acc is None else acc + term
        y = acc.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.permute(0, 3, 1, 2)


class _Conv3x3WgradMM(torch.autograd.Function):
    """The library's convolution for the forward and for dx; the weight
    gradient as 9 tap contractions ([Cin, B*H*W] x [B*H*W, Cout], f32
    accumulation) in place of the library's weight-gradient convolution
    (``layers.py:194-239``)."""

    @staticmethod
    def forward(ctx, x, k, dilation, pad_h):
        ctx.save_for_backward(x, k)
        ctx.dilation, ctx.pad_h = dilation, pad_h
        return F.conv2d(x, k, None, 1, (pad_h, dilation), dilation)

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        d, pad_h = ctx.dilation, ctx.pad_h
        dx = torch.nn.grad.conv2d_input(x.shape, k, g, 1, (pad_h, d), d)
        gh = g.permute(0, 2, 3, 1).float()
        gh = gh.reshape(-1, gh.shape[-1])
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        for ky, kx, win in _taps(x.permute(0, 2, 3, 1).float(), d, pad_h):
            dk[:, :, ky, kx] = (win.reshape(-1, win.shape[-1]).t() @ gh).t()
        return dx, dk.to(k.dtype), None, None


def conv3x3_wgrad_mm(x: torch.Tensor, k: torch.Tensor,
                     dilation: int) -> torch.Tensor:
    """Same-shape stride-1 3x3 conv of NCHW ``x`` and ``k`` (O, I, 3, 3):
    the library's forward and dx, the weight gradient as 9 tap matmuls
    (JAX's ``conv3x3_wgrad_mm``); under a height shard on ``x``'s rows
    padded by ``halo.pad_rows``."""
    x, (pad_h, _) = halo.pad_rows(x, 2 * dilation + 1, 1, dilation)
    return _Conv3x3WgradMM.apply(x, k, dilation, pad_h)


class Conv3x3WgradMM(Conv2d):
    """``Conv2d``-compatible same-shape 3x3 conv backed by
    :func:`conv3x3_wgrad_mm` (``layers.py:241-266``;
    ``set_conv3x3_impl('wgradmm')``)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 bias: bool = False, dtype=torch.float32):
        super().__init__(in_ch, out_ch, 3, 1, dilation, dilation, 1, bias,
                         dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3x3_wgrad_mm(x.to(self.dtype), self.weight.to(self.dtype),
                             self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1)
        return y


class DepthwiseNoWgrad(Conv2d):
    """Diagnostic only (``layers.py:391-412``, ``set_depthwise_impl(
    'xla_nowgrad')``): the grouped 3x3 conv with its weight detached, so the
    backward takes no depthwise weight gradient and its cost can be measured
    by subtraction. Never for training."""

    def __init__(self, features: int, stride: int = 1, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__(features, features, 3, stride, 0, dilation,
                         features, False, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.detach().to(self.dtype),
                        None, self.stride, 0, self.dilation, self.groups)


_DEPTHWISE_IMPL = "xla"
_CONV3X3_IMPL = "xla"


def set_depthwise_impl(name: str) -> None:
    """'xla' (the library's grouped conv, default; the name is the JAX
    package's), 'pallas' (the hand-written kernel of ``ops/depthwise.py``;
    ``--pallas_dw``) or 'xla_nowgrad' (:class:`DepthwiseNoWgrad`,
    diagnostic). Process-global, read when a model is built."""
    global _DEPTHWISE_IMPL
    if name not in ("xla", "pallas", "xla_nowgrad"):
        raise ValueError(name)
    _DEPTHWISE_IMPL = name


def set_conv3x3_impl(name: str) -> None:
    """'xla' (the library's convolution, default), 'matmul'
    (:class:`Conv3x3MatMul`; ``--conv3x3_matmul``) or 'wgradmm'
    (:class:`Conv3x3WgradMM`) for same-shape stride-1 3x3 convs.
    Process-global, read when a model is built."""
    global _CONV3X3_IMPL
    if name not in ("xla", "matmul", "wgradmm"):
        raise ValueError(name)
    _CONV3X3_IMPL = name


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, *,
         dilation: int = 1, padding: int = 0, groups: int = 1,
         bias: bool = False, dtype=torch.float32) -> nn.Module:
    """The conv factory's dispatch (``layers.py:269-321``)."""
    if kernel == 1 and stride == 1 and groups == 1 and padding == 0:
        return Conv1x1(in_ch, out_ch, bias, dtype)
    same3x3 = kernel == 3 and stride == 1 and groups == 1 \
        and padding == dilation
    if same3x3 and _CONV3X3_IMPL == "matmul":
        return Conv3x3MatMul(in_ch, out_ch, dilation, bias, dtype)
    if same3x3 and _CONV3X3_IMPL == "wgradmm":
        return Conv3x3WgradMM(in_ch, out_ch, dilation, bias, dtype)
    depthwise = kernel == 3 and groups == out_ch and in_ch == out_ch \
        and not bias and padding == 0
    if depthwise and _DEPTHWISE_IMPL == "pallas":
        return PallasDepthwise(out_ch, stride, dilation, dtype)
    if depthwise and _DEPTHWISE_IMPL == "xla_nowgrad":
        return DepthwiseNoWgrad(out_ch, stride, dilation, dtype)
    return Conv2d(in_ch, out_ch, kernel, stride, padding, dilation, groups,
                  bias, dtype)


def fixed_padding_amounts(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """TF-style explicit padding used by the reference MobileNetV2
    (``networks/mobilenet_v2.py:15-21``)."""
    effective = kernel_size + (kernel_size - 1) * (dilation - 1)
    total = effective - 1
    beg = total // 2
    return beg, total - beg


def fixed_pad(x: torch.Tensor, kernel_size: int, dilation: int,
              stride: int = 1) -> torch.Tensor:
    """Pad H and W of an NCHW tensor (memory format kept) for the VALID
    window of ``kernel_size`` at ``dilation`` and ``stride`` that follows.
    Under a height shard the rows are the ones that window reads, the
    neighbours' between stripes (the stride-2 window takes the top halo
    row only)."""
    beg, end = fixed_padding_amounts(kernel_size, dilation)
    x, (pad_h, _) = halo.pad_rows(x, (kernel_size - 1) * dilation + 1,
                                  stride, beg)
    return F.pad(x, (beg, end, pad_h, pad_h + end - beg))
