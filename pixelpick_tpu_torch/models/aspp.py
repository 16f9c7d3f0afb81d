"""Atrous Spatial Pyramid Pooling (reference ``networks/aspp.py``).

Counterpart of ``pixelpick_tpu/models/aspp.py``: four atrous branches
(dilations 1/6/12/18 at os=16, 1/12/24/36 at os=8) plus a global-average-pool
branch, concatenated 5x256 -> 1x1 conv 256. The reference's bilinear
align-corners upsample of the 1x1 pooled map is a broadcast
(``aspp.py:44-50``). The output passes ``Dropout(0.5)`` (``aspp.py:56``),
active in train mode or under ``mc_dropout_on`` (the MC-dropout committee).
Module names follow the reference. Under a height shard the atrous convs
take their halos in ``Conv2d`` and the pooling sums over the ranks.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pixelpick_tpu_torch.models.layers import BatchNorm, Dropout, conv
from pixelpick_tpu_torch.parallel import halo


class _GlobalMean(nn.Module):
    """The mean over H and W; under a height shard, over the whole map's
    (``halo.mean``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return halo.mean(x, (2, 3), axis=2, keepdim=True)


class _ASPPModule(nn.Module):
    def __init__(self, inplanes: int, planes: int, kernel: int, padding: int,
                 dilation: int, dtype, bn_groups: int):
        super().__init__()
        self.atrous_conv = conv(inplanes, planes, kernel, padding=padding,
                                dilation=dilation, dtype=dtype)
        self.bn = BatchNorm(planes, dtype, groups=bn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP(nn.Module):
    def __init__(self, inplanes: int, output_stride: int = 16,
                 dtype=torch.float32, bn_groups: int = 0):
        super().__init__()
        if output_stride == 16:
            dilations = (1, 6, 12, 18)
        elif output_stride == 8:
            dilations = (1, 12, 24, 36)
        else:
            raise NotImplementedError(output_stride)
        for i, d in enumerate(dilations, start=1):
            k, pad = (1, 0) if d == 1 else (3, d)
            setattr(self, f"aspp{i}",
                    _ASPPModule(inplanes, 256, k, pad, d, dtype, bn_groups))
        self.global_avg_pool = nn.Sequential(
            _GlobalMean(), conv(inplanes, 256, 1, dtype=dtype),
            BatchNorm(256, dtype, groups=bn_groups), nn.ReLU())
        self.conv1 = conv(1280, 256, 1, dtype=dtype)
        self.bn1 = BatchNorm(256, dtype, groups=bn_groups)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor,
                mc_dropout_on: bool = False) -> torch.Tensor:
        branches = [getattr(self, f"aspp{i}")(x) for i in range(1, 5)]
        branches.append(self.global_avg_pool(x).expand_as(branches[0]))
        h = torch.cat(branches, dim=1)  # 1280
        return self.dropout(F.relu(self.bn1(self.conv1(h))),
                            active=self.training or mc_dropout_on)
