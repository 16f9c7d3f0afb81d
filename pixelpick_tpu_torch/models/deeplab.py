"""DeepLabv3+ (MobileNetV2 + ASPP + decoder head), eval mode.

Counterpart of ``pixelpick_tpu/models/deeplab.py`` (reference
``networks/deeplab.py:12-61``, head ``networks/decoders.py:104-132``):

  backbone -> (high 1/16, low 1/4)
  ASPP(high) -> 256ch, bilinear align-corners up to 1/4
  low -> 1x1 conv 24->48 + BN + ReLU
  concat [aspp | low] -> 304ch
  SegmentHead: 3x3 304->256 BN ReLU, 3x3 256->256 BN ReLU, 1x1 -> n_classes
  pred & emb bilinear align-corners up to input resolution

``upsample=False`` returns the 1/4-resolution head outputs
(``deeplab.py:99-100``). The model takes and returns NHWC, the JAX layout;
inside it runs NCHW in ``channels_last`` memory format, so the permutes at
either end are views. The reference's dropouts are identities in eval mode
and come with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from pixelpick_tpu_torch.models.aspp import ASPP
from pixelpick_tpu_torch.models.layers import BatchNorm, conv
from pixelpick_tpu_torch.models.mobilenet_v2 import MobileNetV2
from pixelpick_tpu_torch.ops.resize import resize_align_corners


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SegmentHead(nn.Module):
    """DeepLabv3+ decoder head (decoders.py:104-132); the reference's
    indices 3 and 7 are its dropouts."""

    def __init__(self, n_classes: int, in_ch: int = 304, dtype=torch.float32):
        super().__init__()
        self.segment_head = nn.Sequential(
            conv(in_ch, 256, 3, padding=1, dtype=dtype), BatchNorm(256, dtype),
            nn.ReLU(), nn.Identity(),
            conv(256, 256, 3, padding=1, dtype=dtype), BatchNorm(256, dtype),
            nn.ReLU(), nn.Identity())
        self.classifier = conv(256, n_classes, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor):
        emb = self.segment_head(x)
        return emb, self.classifier(emb)


class DeepLab(nn.Module):
    def __init__(self, n_classes: int, output_stride: int = 16,
                 width_mult: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.backbone = MobileNetV2(output_stride, width_mult, dtype)
        self.aspp = ASPP(self.backbone.out_channels, output_stride, dtype)
        self.low_level_conv = nn.Sequential(
            conv(self.backbone.low_channels, 48, 1, dtype=dtype),
            BatchNorm(48, dtype), nn.ReLU())
        self.seg_head = SegmentHead(n_classes, 256 + 48, dtype)

    def forward(self, x: torch.Tensor,
                upsample: bool = True) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalised NHWC. Returns NHWC ``pred`` and
        ``emb``, at (H, W) in f32, or at 1/4 resolution in the compute dtype
        when ``upsample`` is False."""
        high, low = self.backbone(x.permute(0, 3, 1, 2))
        a = self.aspp(high)
        ll = self.low_level_conv(low)
        a = resize_align_corners(_nhwc(a), ll.shape[2:]).permute(0, 3, 1, 2)
        h = torch.cat([a, ll], dim=1)  # [256 | 48] (deeplab.py:50)
        emb, pred = self.seg_head(h)
        if not upsample:
            return {"pred": _nhwc(pred), "emb": _nhwc(emb)}
        out_hw = x.shape[1:3]
        return {
            "pred": resize_align_corners(_nhwc(pred).float(), out_hw),
            "emb": resize_align_corners(_nhwc(emb).float(), out_hw),
        }
