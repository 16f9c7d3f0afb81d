"""MobileNetV2 backbone for DeepLabv3+.

Counterpart of ``pixelpick_tpu/models/mobilenet_v2.py`` (reference
``networks/mobilenet_v2.py``):

- the inverted-residual settings table with the reference's output-stride
  dilation schedule (at os=16 the (6,96,3,1) and (6,160,3,2) groups run
  stride 1 / dilation 1 and the final (6,320,1,1) group dilation 2);
- TF-style ``fixed_padding`` applied to the *block input*, before the 1x1
  expand conv, so the depthwise conv runs VALID;
- features split after block 2: low-level (stride 4) / high-level
  (stride 16).

Module names follow the reference (``features.0`` the stem,
``features.{i+1}.conv.{j}`` the blocks), which is the layout
``pixelpick_tpu.models.convert.convert_deeplab`` reads. With ``fused_ir``
the stride-1 t=6 blocks are ``FusedIRBlock``s (``models/fused_block.py``),
which keep ``InvertedResidual``'s names (``mobilenet_v2.py:165-170``).

With ``mc_dropout`` (``--use_mc_dropout``) two ``Dropout2d`` sites follow
the features, ``feat_dropout`` on the high-level and ``low_dropout`` on the
low-level ones (``mobilenet_v2.py:181-186``). They are active in train mode,
and in committee scoring only with ``mc_dropout2d_committee``: the
reference's ``turn_on_dropout`` re-enables ``nn.Dropout`` modules only, and
``nn.Dropout2d`` is not one (``mobilenet_v2.py:101-102``).
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from pixelpick_tpu_torch.models.layers import (
    BatchNorm, Dropout2d, ReLU6, conv, fixed_pad, frozen_running_stats,
)
from pixelpick_tpu_torch.ops.s2d import from_s2d, to_s2d
from pixelpick_tpu_torch.parallel import halo

# (expand_ratio t, channels c, repeats n, stride s) — mobilenet_v2.py:82-91
INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def block_plan(output_stride: int, width_mult: float = 1.0):
    """Expand the settings table into per-block (in, out, stride, dilation,
    expand_ratio), reproducing the reference's stride->dilation loop."""
    plan = []
    input_channel = int(32 * width_mult)
    current_stride = 2  # after the stem conv
    rate = 1
    for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
        if current_stride == output_stride:
            stride, dilation = 1, rate
            rate *= s
        else:
            stride, dilation = s, 1
            current_stride *= s
        out_channel = int(c * width_mult)
        for i in range(n):
            plan.append((input_channel, out_channel,
                         stride if i == 0 else 1, dilation, t))
            input_channel = out_channel
    return plan, input_channel


class InvertedResidual(nn.Module):
    """One inverted-residual block (mobilenet_v2.py:24-66). With ``remat``
    (``MobileNetV2``'s ``remat_blocks``) a train-mode forward that records a
    graph keeps only the block input and recomputes the block in the
    backward, as flax's ``nn.checkpoint``; the recompute leaves the running
    statistics alone, so the EMA is applied once."""

    Norm = BatchNorm

    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand_ratio: int, dtype=torch.float32, bn_groups: int = 0):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        self.stride, self.dilation = stride, dilation
        self.dtype, self.bn_groups = dtype, bn_groups
        self.remat = False
        norm = self.Norm
        layers = []
        if expand_ratio != 1:
            layers += [conv(inp, hidden, 1, dtype=dtype),
                       norm(hidden, dtype, groups=bn_groups), ReLU6()]
        layers += [conv(hidden, hidden, 3, stride, dilation=dilation,
                        groups=hidden, dtype=dtype),
                   norm(hidden, dtype, groups=bn_groups), ReLU6(),
                   conv(hidden, oup, 1, dtype=dtype),
                   norm(oup, dtype, groups=bn_groups)]
        self.conv = nn.Sequential(*layers)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        # pad the block input (:61)
        h = self.conv(fixed_pad(x, 3, self.dilation, self.stride))
        return x + h if self.use_res else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(
                self._block, x, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    frozen_running_stats()))
        return self._block(x)


class MobileNetV2(nn.Module):
    def __init__(self, output_stride: int = 16, width_mult: float = 1.0,
                 dtype=torch.float32, bn_groups: int = 0,
                 fused_ir: bool = False, mc_dropout: bool = False,
                 mc_dropout_p: float = 0.2,
                 mc_dropout2d_committee: bool = False, s2d_until: int = 0,
                 remat_blocks: bool = False):
        super().__init__()
        from pixelpick_tpu_torch.models.fused_block import FusedIRBlock
        from pixelpick_tpu_torch.models.s2d_block import (
            FusedIRBlockS2D, InvertedResidualS2D,
        )

        plan, self.out_channels = block_plan(output_stride, width_mult)
        self.low_channels = plan[2][1]
        stem_ch = int(32 * width_mult)
        # stem: conv 3x3 stride 2, torch padding=1 (mobilenet_v2.py:7-12)
        stem = nn.Sequential(conv(3, stem_ch, 3, 2, padding=1, dtype=dtype),
                             BatchNorm(stem_ch, dtype, groups=bn_groups),
                             ReLU6())
        blocks = []
        for i, (inp, oup, stride, d, t) in enumerate(plan):
            fused = fused_ir and stride == 1 and t != 1
            if i < s2d_until and d == 1:
                block = FusedIRBlockS2D if fused else InvertedResidualS2D
            else:
                block = FusedIRBlock if fused else InvertedResidual
            blocks.append(block(inp, oup, stride, d, t, dtype=dtype,
                                bn_groups=bn_groups))
            # the JAX package rematerialises the unfused blocks only
            blocks[-1].remat = remat_blocks and not fused
        self.features = nn.Sequential(stem, *blocks)
        self.mc_dropout2d_committee = mc_dropout2d_committee
        if mc_dropout:
            self.feat_dropout = Dropout2d(mc_dropout_p)
            self.low_dropout = Dropout2d(mc_dropout_p)

    def forward(self, x: torch.Tensor, mc_dropout_on: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW in; returns (high_level 1/16, low_level 1/4). The s2d blocks
        run in s2d layout while their input has an even height and width
        (``mobilenet_v2.py:146-175``), each block deciding from its own
        input, and the standard way otherwise. Under a height shard the
        height is the whole map's, so that every rank takes the same path
        at every block."""
        h = self.features[0](x)
        low = None
        in_s2d = False
        for i, block in enumerate(self.features[1:]):
            use_s2d = hasattr(block, "forward_s2d") and (
                in_s2d or (halo.bounds(h.shape[2])[0][-1] % 2 == 0
                           and h.shape[3] % 2 == 0))
            if use_s2d:
                if not in_s2d:
                    h, in_s2d = to_s2d(h), True
                h = block.forward_s2d(h)
                # the stride-2 cell conv emits the normal layout
                in_s2d = block.stride == 1
            else:
                if in_s2d:
                    h, in_s2d = from_s2d(h), False
                h = block(h)
            if i == 2:  # features[0:4] = stem + blocks 0..2 (:125)
                low = from_s2d(h) if in_s2d else h
        if in_s2d:
            h = from_s2d(h)
        if hasattr(self, "feat_dropout"):
            on = self.training or (mc_dropout_on
                                   and self.mc_dropout2d_committee)
            h = self.feat_dropout(h, active=on)
            low = self.low_dropout(low, active=on)
        return h, low
