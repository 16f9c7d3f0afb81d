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
dropout draws are the global batch's. Parameter
and buffer names follow the reference's torch modules (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``).

Train mode: BatchNorm is the JAX package's ghost BN (``ghost_bn_train``,
``_BNCore``), not ``nn.BatchNorm2d``, whose running variance is the unbiased
one. ReLU6 is ``min(max(x, 0), 6)``, whose gradient is 0.5 at exactly 0 and
6, as JAX's (``torch.clamp`` gives 1 and ``F.relu6`` 0 there). The dropouts
draw from an explicit ``torch.Generator`` when one is set.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from pixelpick_tpu_torch.ops.depthwise import depthwise_conv3x3
from pixelpick_tpu_torch.parallel import distributed, mesh


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


def ghost_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, eps: float, dtype):
    """Train-mode (ghost) BatchNorm of NCHW ``x`` (``layers.py:22-38``):
    contiguous groups of ``groups`` samples, or the whole batch when
    ``groups`` does not divide it; f32 fast variance max(0, E[x^2] -
    E[x]^2). Returns (y in ``dtype``, mu, var) with mu/var (n_groups, C)
    f32.

    Under a row shard (``parallel/mesh.py:sharded``) ``x`` is this rank's
    rows of the global batch, and the groups are the global batch's, as
    JAX traces the global shape. A group within the rank's rows is
    computed here, with no collective, and mu/var are the rank's groups;
    groups that span ranks take their sums of x and x^2 from a
    differentiable all-reduce (its backward reduces the gradient terms as
    well), and mu/var are every group's."""
    shard = mesh.current_shard()
    lo, b = (0, x.shape[0]) if shard is None else (shard.lo, shard.rows)
    g = group_size(groups, b)
    xf = x.float()
    # each row's group among those mu and var hold
    group = torch.arange(lo, lo + x.shape[0], device=x.device) // g
    if shard is None or (x.shape[0] % g == 0 and lo % g == 0):
        xg = xf.reshape(x.shape[0] // g, g, *x.shape[1:])
        mu = xg.mean((1, 3, 4))
        mu2 = (xg * xg).mean((1, 3, 4))
        group = group - lo // g
    else:
        # each row's f32 sums, added across rows and ranks in f64, so that
        # the moments round once, as the local groups' means do
        rows = torch.stack([xf.sum((2, 3)), (xf * xf).sum((2, 3))], 1)
        sums = torch.zeros((b // g, 2, x.shape[1]), dtype=torch.float64,
                           device=x.device).index_add(0, group, rows.double())
        sums = dist_nn.all_reduce(sums) / (g * x.shape[2] * x.shape[3])
        mu, mu2 = sums[:, 0].float(), sums[:, 1].float()
    var = torch.maximum(torch.zeros((), device=x.device), mu2 - mu * mu)
    mul = (torch.rsqrt(var + eps) * scale)[group][..., None, None]
    y = (xf - mu[group][..., None, None]) * mul + bias.view(1, -1, 1, 1)
    return y.to(dtype), mu, var


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
        every rank keeps the same statistics."""
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
        # the global batch's draw, sliced to this rank's rows
        u = mesh.rand_rows(shape, self.generator, x.device)
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
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding, self.dilation, self.groups)


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


_DEPTHWISE_IMPL = "xla"


def set_depthwise_impl(name: str) -> None:
    """'xla' (the library's grouped conv, default; the name is the JAX
    package's) or 'pallas' (the hand-written kernel of ``ops/depthwise.py``;
    ``--pallas_dw``). Process-global, read when a model is built."""
    global _DEPTHWISE_IMPL
    if name not in ("xla", "pallas"):
        raise ValueError(name)
    _DEPTHWISE_IMPL = name


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, *,
         dilation: int = 1, padding: int = 0, groups: int = 1,
         bias: bool = False, dtype=torch.float32) -> nn.Module:
    """The conv factory's dispatch (``layers.py:269-321``)."""
    if kernel == 1 and stride == 1 and groups == 1 and padding == 0:
        return Conv1x1(in_ch, out_ch, bias, dtype)
    if (_DEPTHWISE_IMPL == "pallas" and kernel == 3 and groups == out_ch
            and in_ch == out_ch and not bias and padding == 0):
        return PallasDepthwise(out_ch, stride, dilation, dtype)
    return Conv2d(in_ch, out_ch, kernel, stride, padding, dilation, groups,
                  bias, dtype)


def fixed_padding_amounts(kernel_size: int, dilation: int) -> Tuple[int, int]:
    """TF-style explicit padding used by the reference MobileNetV2
    (``networks/mobilenet_v2.py:15-21``)."""
    effective = kernel_size + (kernel_size - 1) * (dilation - 1)
    total = effective - 1
    beg = total // 2
    return beg, total - beg


def fixed_pad(x: torch.Tensor, kernel_size: int, dilation: int) -> torch.Tensor:
    """Pad H and W of an NCHW tensor (memory format kept)."""
    beg, end = fixed_padding_amounts(kernel_size, dilation)
    return F.pad(x, (beg, end, beg, end))
