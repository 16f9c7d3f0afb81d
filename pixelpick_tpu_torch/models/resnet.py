"""ResNet backbones (18/34/50/101) with the dilated-stride variant.

Counterpart of ``pixelpick_tpu/models/resnet.py`` (reference
``networks/backbones/resnet_models.py``, ``resnet_backbone.py``):

- torchvision-style ResNet v1: a 7x7/s2 stem (or the deep-base 3x 3x3
  stem), a 3x3/s2 max pool padded with -inf, BasicBlock for 18/34 and
  Bottleneck (the stride on the 3x3) for 50/101;
- the dilated transform (``_stage_plan``, reference ``_nostride_dilate``
  with ``multi_grid=None``): at ``dilate_scale=8`` layer3 runs at stride 1
  and dilation 2, layer4 at stride 1 and dilation 4, and the first block's
  3x3 gets half the stage's dilation; 16 dilates layer4 alone; 0 keeps the
  stride-32 network;
- returns the four stage features ``[c2, c3, c4, c5]``, NCHW in
  ``channels_last``.

Widths scale uniformly by ``width_multiplier``, as the JAX package scales
them (the deep-base stem keeps 64/64/128). Module names are the
reference's torch layout (``prefix.conv1/bn1``, ``layer{L}.{B}.conv{i}/
bn{i}``, ``layer{L}.{B}.downsample.0/1``), which the JAX package's
``convert_resnet_backbone`` reads. Convolutions are initialised He-normal
fan-out (``models/factory.py:init_model``), BatchNorm is the ghost-BN
``BatchNorm`` of ``models/layers.py``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from pixelpick_tpu_torch.models.layers import BatchNorm, conv
from pixelpick_tpu_torch.parallel import halo

LAYER_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 downsample: bool = False, dtype=torch.float32,
                 bn_groups: int = 0):
        super().__init__()
        self.conv1 = conv(in_ch, planes, 3, stride, padding=first_dilation,
                          dilation=first_dilation, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype, groups=bn_groups)
        self.conv2 = conv(planes, planes, 3, padding=dilation,
                          dilation=dilation, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype, groups=bn_groups)
        self.downsample = nn.Sequential(
            conv(in_ch, planes, 1, stride, dtype=dtype),
            BatchNorm(planes, dtype, groups=bn_groups)) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 downsample: bool = False, dtype=torch.float32,
                 bn_groups: int = 0):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = conv(in_ch, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype, groups=bn_groups)
        # the stride lives on the 3x3 (resnet_models.py:65-66)
        self.conv2 = conv(planes, planes, 3, stride, padding=first_dilation,
                          dilation=first_dilation, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype, groups=bn_groups)
        self.conv3 = conv(planes, out_ch, 1, dtype=dtype)
        self.bn3 = BatchNorm(out_ch, dtype, groups=bn_groups)
        self.downsample = nn.Sequential(
            conv(in_ch, out_ch, 1, stride, dtype=dtype),
            BatchNorm(out_ch, dtype, groups=bn_groups)) if downsample \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


def stage_plan(dilate_scale: int):
    """Per-stage (stride, dilation, first-block dilation)
    (``resnet.py:99-111``)."""
    plan = [(1, 1, 1), (2, 1, 1), (2, 1, 1), (2, 1, 1)]
    if dilate_scale == 8:
        plan[2] = (1, 2, 1)
        plan[3] = (1, 4, 2)
    elif dilate_scale == 16:
        plan[3] = (1, 2, 1)
    return plan


def stage_channels(n_layers: int, width_multiplier: float) -> List[int]:
    """Channels of ``[c2, c3, c4, c5]``."""
    kind, _ = LAYER_SPECS[n_layers]
    expansion = 1 if kind == "basic" else 4
    return [int(64 * 2 ** i * width_multiplier) * expansion for i in range(4)]


class _Stem(nn.Module):
    """The reference's ``prefix`` Sequential: conv1/bn1 (and the deep-base
    conv2/bn2/conv3/bn3), each conv followed by its BatchNorm and a ReLU."""

    def __init__(self, widths, dtype, bn_groups: int):
        super().__init__()
        self.n = len(widths)
        in_ch = 3
        for i, out_ch in enumerate(widths, start=1):
            if self.n == 1:
                c = conv(in_ch, out_ch, 7, 2, padding=3, dtype=dtype)
            else:
                c = conv(in_ch, out_ch, 3, 2 if i == 1 else 1, padding=1,
                         dtype=dtype)
            setattr(self, f"conv{i}", c)
            setattr(self, f"bn{i}", BatchNorm(out_ch, dtype, groups=bn_groups))
            in_ch = out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n + 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3 / stride-2 max pool, padded with -inf as the JAX
    package's; under a height shard the pad rows between stripes are the
    neighbours' rows."""
    x, (pad_h, _) = halo.pad_rows(x, 3, 2, 1, float("-inf"))
    return F.max_pool2d(x, 3, 2, (pad_h, 1))


class ResNetBackbone(nn.Module):
    """NCHW input -> ``[c2, c3, c4, c5]`` (``resnet.py:114-171``)."""

    def __init__(self, n_layers: int = 50, dilate_scale: int = 8,
                 width_multiplier: float = 1.0, deep_base: bool = False,
                 dtype=torch.float32, bn_groups: int = 0):
        super().__init__()
        kind, depths = LAYER_SPECS[n_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        w = width_multiplier
        widths = (64, 64, 128) if deep_base else (int(64 * w),)
        self.prefix = _Stem(widths, dtype, bn_groups)
        in_ch = widths[-1]
        for li, (n_blocks, (stride, dil, first_dil)) in enumerate(
                zip(depths, stage_plan(dilate_scale)), start=1):
            planes = int(64 * 2 ** (li - 1) * w)
            blocks = []
            for bi in range(n_blocks):
                down = bi == 0 and (stride != 1
                                    or in_ch != planes * block.expansion)
                blocks.append(block(in_ch, planes,
                                    stride=stride if bi == 0 else 1,
                                    dilation=dil,
                                    first_dilation=first_dil if bi == 0
                                    else dil,
                                    downsample=down, dtype=dtype,
                                    bn_groups=bn_groups))
                in_ch = planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = max_pool_3x3_s2(self.prefix(x))
        feats = []
        for li in range(1, 5):
            h = getattr(self, f"layer{li}")(h)
            feats.append(h)
        return feats
