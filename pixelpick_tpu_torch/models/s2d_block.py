"""Inverted-residual block evaluated in space-to-depth (s2d) layout: exact.

Counterpart of ``pixelpick_tpu/models/s2d_block.py`` (``--s2d_backbone``;
the math is in ``ops/s2d.py``). :class:`InvertedResidualS2D` is an
:class:`InvertedResidual` (the same modules, so the same parameter and
buffer names, ``conv.{j}.weight`` and the BatchNorms' five tensors; the
weight bridge, checkpoints and ``--pretrained_ckpt`` need nothing new, as
JAX's ``s2d_block.py:21-23`` holds for its tree). Its ``forward`` is the
standard block's, which ``MobileNetV2`` takes where an input is odd-sized;
:meth:`InvertedResidualS2D.forward_s2d` consumes a phase-major s2d tensor
(B, 4*inp, H/2, W/2) and reproduces the reference block, including the pad
before the block:

- expand and project 1x1 convs -> phase-batched matmuls;
- the expand BatchNorm takes its moments over the padded map's
  (H+2)(W+2) pixels per sample (the rim, a 1x1 conv of zeros, adds zeros
  to the sums; ``s2d_block.py:151-161``);
- the depthwise taps that read the rim's relu6(BN(0)) values are restored
  by ``rho * border_weight_map``, ``rho`` per ghost-BN group in train mode
  and from the running statistics in eval mode (``:169-177``);
- stride 1 emits s2d layout; stride 2 emits the normal layout, where the
  tail (dw BN, project) runs through the standard modules (``:189-197``).

Under ``--spatial_query_sharding`` (eval only) the block runs on a rank's
row stripe: the cell convs take their halo from ``parallel/halo.py`` and
the border map is the whole map's rows of this stripe, as JAX's global
view computes it.

The phase-grouped BatchNorm (JAX's ``_S2DBNCore``/``S2DBatchNorm``) is
:class:`S2DBatchNorm`, a :class:`BatchNorm` with one more method: its
train-mode moments come from ``ghost_bn_train`` on the phase-folded tensor
(B, C, 4h, w), so ghost groups, groups that span ranks under a row shard
(``--data_parallel``) and the running-stat EMA are the standard
BatchNorm's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pixelpick_tpu_torch.models import layers
from pixelpick_tpu_torch.models.fused_block import FusedIRBlock
from pixelpick_tpu_torch.models.layers import BatchNorm, relu6
from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual
from pixelpick_tpu_torch.ops.s2d import (
    border_weight_map, conv_s2d_1x1, conv_s2d_dw, rep_phase, to_s2d,
)
from pixelpick_tpu_torch.parallel import halo


class S2DBatchNorm(BatchNorm):
    """A :class:`BatchNorm` (the same tensors, one per original channel)
    that also normalises phase-major s2d tensors: :meth:`forward_s2d`. Its
    ``forward`` is the standard one."""

    def forward_s2d(self, x: torch.Tensor, count: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 4C, h, w) -> (y, bn_zero): y in the compute dtype and
        bn_zero, the normalisation of an exact zero, per row (B, C), or
        (1, C) in eval mode. ``count``: the pixels per sample the moments
        divide by, in place of 4hw."""
        b, c4, h, w = x.shape
        c = c4 // 4
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            shape = (1, -1, 1, 1)
            y = (x.float() - rep_phase(self.running_mean).view(shape)) \
                * rep_phase(mul).view(shape) + rep_phase(self.bias).view(shape)
            return y.to(self.dtype), (-self.running_mean * mul
                                      + self.bias)[None]
        layers.refuse_height_shard()
        # the 4 phases of a channel side by side along H: (B, C, 4h, w)
        folded = x.reshape(b, 4, c, h, w).transpose(1, 2).reshape(
            b, c, 4 * h, w)
        _, group, _ = layers.row_groups(folded, self.groups)
        y, mu, var = layers.ghost_bn_train(
            folded, self.weight, self.bias, self.groups, self.eps,
            self.dtype, count)
        self.update_running_stats(mu.detach(), var.detach())
        bn_zero = -mu * torch.rsqrt(var + self.eps) * self.weight + self.bias
        y = y.reshape(b, c, 4, h, w).transpose(1, 2).reshape(b, c4, h, w)
        return y.contiguous(memory_format=torch.channels_last), \
            bn_zero[group]


class InvertedResidualS2D(InvertedResidual):
    """One inverted-residual block that can run in s2d layout (dilation 1,
    the early blocks' case); its BatchNorms are :class:`S2DBatchNorm`s."""

    Norm = S2DBatchNorm

    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand_ratio: int, dtype=torch.float32, bn_groups: int = 0):
        if dilation != 1:
            raise ValueError(f"s2d blocks run at dilation 1, not {dilation}")
        super().__init__(inp, oup, stride, dilation, expand_ratio, dtype,
                         bn_groups)
        self.expands = expand_ratio != 1

    def forward_s2d(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 4*inp, h, w) phase-major s2d -> s2d (stride 1) or the
        normal layout (stride 2)."""
        mods = list(self.conv)
        dt = self.dtype
        h2, w2 = x.shape[2:]
        # the whole block input's extent (a height shard splits the rows)
        ho, wo = 2 * halo.bounds(h2)[0][-1], 2 * w2
        pad_count = (ho + 2) * (wo + 2)    # the fixed_padding'ed map's pixels

        def mm(z, conv):
            return conv_s2d_1x1(z, conv.weight[:, :, 0, 0].t().to(dt))

        if self.expands:
            expand, bn1, _ = mods[:3]
            mods = mods[3:]
            # the reference's BN sees the padded map (rim = conv of zeros =
            # 0): the same sums, the padded count
            h, bn_zero = bn1.forward_s2d(mm(x.to(dt), expand), pad_count)
            h = relu6(h)
            rho = relu6(bn_zero)           # (B or 1, hidden): the rim value
        else:
            h = x.to(dt)
            rho = None                     # the rim is a literal zero
        dw, bn2, _, project, bn3 = mods
        wdw = dw.weight[:, 0].permute(1, 2, 0).to(dt)  # (3, 3, hidden)
        y = conv_s2d_dw(h, wdw, self.stride)
        if rho is not None:
            # the whole map's, narrowed to this rank's output rows
            m = border_weight_map(wdw, (ho, wo), self.stride)
            rho = rho.to(dt)
            if self.stride == 1:  # phase-major channels
                m, rho = to_s2d(halo.stripe(m, 2 * h2)), rep_phase(rho)
            else:
                m = halo.stripe(m, h2)
            y = y + rho[:, :, None, None] * m
        if self.stride == 1:
            y = relu6(bn2.forward_s2d(y)[0])
            y = bn3.forward_s2d(mm(y, project))[0]
            return x + y if self.use_res else y
        # stride 2: the normal layout from here on, the standard modules
        return bn3(project(relu6(bn2(y))))


class FusedIRBlockS2D(InvertedResidualS2D, FusedIRBlock):
    """Block 2 under ``--fused_ir --s2d_backbone``: the s2d path where the
    input allows it, else the fused block's ``forward``, as JAX picks per
    call (``mobilenet_v2.py:149-170``)."""
