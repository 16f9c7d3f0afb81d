"""DeepLabv3+ (MobileNetV2 + ASPP + decoder head).

Counterpart of ``pixelpick_tpu/models/deeplab.py`` (reference
``networks/deeplab.py:12-61``, head ``networks/decoders.py:104-132``):

  backbone -> (high 1/16, low 1/4)
  ASPP(high) -> 256ch, bilinear align-corners up to 1/4
  low -> 1x1 conv 24->48 + BN + ReLU
  concat [aspp | low] -> 304ch
  SegmentHead: 3x3 304->256 BN ReLU Drop(0.5), 3x3 256->256 BN ReLU
               Drop(mc_p), 1x1 -> n_classes
  pred & emb bilinear align-corners up to input resolution

``upsample=False`` returns the 1/4-resolution head outputs
(``deeplab.py:99-100``), which the sparse train loss reads. The model takes
and returns NHWC, the JAX layout; inside it runs NCHW in ``channels_last``
memory format, so the permutes at either end are views. The dropouts are
active in train mode, and ASPP's and the head's also under
``mc_dropout_on`` (the MC-dropout committee scores in eval mode, BatchNorm
on its running statistics; ``deeplab.py:46, 50-51``). They draw from the
generator that ``set_dropout_generator`` installs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from pixelpick_tpu_torch.models.aspp import ASPP
from pixelpick_tpu_torch.models.layers import BatchNorm, Dropout, conv
from pixelpick_tpu_torch.models.mobilenet_v2 import MobileNetV2
from pixelpick_tpu_torch.ops.resize import resize_align_corners


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SegmentHead(nn.Module):
    """DeepLabv3+ decoder head (decoders.py:104-132); the reference's
    indices 3 and 7 are its dropouts (``deeplab.py:46,50-51``)."""

    def __init__(self, n_classes: int, in_ch: int = 304, dtype=torch.float32,
                 mc_dropout_p: float = 0.2, bn_groups: int = 0):
        super().__init__()
        self.segment_head = nn.Sequential(
            conv(in_ch, 256, 3, padding=1, dtype=dtype),
            BatchNorm(256, dtype, groups=bn_groups), nn.ReLU(), Dropout(0.5),
            conv(256, 256, 3, padding=1, dtype=dtype),
            BatchNorm(256, dtype, groups=bn_groups), nn.ReLU(),
            Dropout(mc_dropout_p))
        self.classifier = conv(256, n_classes, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, mc_dropout_on: bool = False):
        emb = x
        for m in self.segment_head:
            emb = m(emb, active=self.training or mc_dropout_on) \
                if isinstance(m, Dropout) else m(emb)
        return emb, self.classifier(emb)


class DeepLab(nn.Module):
    def __init__(self, n_classes: int, output_stride: int = 16,
                 width_mult: float = 1.0, dtype=torch.float32,
                 mc_dropout_p: float = 0.2, bn_groups: int = 0,
                 fused_ir: bool = False, mc_dropout: bool = False,
                 mc_dropout2d_committee: bool = False, s2d_until: int = 0,
                 remat_blocks: bool = False):
        super().__init__()
        self.backbone = MobileNetV2(output_stride, width_mult, dtype,
                                    bn_groups, fused_ir, mc_dropout,
                                    mc_dropout_p, mc_dropout2d_committee,
                                    s2d_until, remat_blocks)
        self.aspp = ASPP(self.backbone.out_channels, output_stride, dtype,
                         bn_groups)
        self.low_level_conv = nn.Sequential(
            conv(self.backbone.low_channels, 48, 1, dtype=dtype),
            BatchNorm(48, dtype, groups=bn_groups), nn.ReLU())
        self.seg_head = SegmentHead(n_classes, 256 + 48, dtype, mc_dropout_p,
                                    bn_groups)
        # the backbone's total stride: the height shard's unit
        self.total_stride = output_stride

    def set_dropout_generator(self,
                              generator: Optional[torch.Generator]) -> None:
        """Every dropout of the model draws its masks from ``generator``."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def forward(self, x: torch.Tensor, upsample: bool = True,
                mc_dropout_on: bool = False) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalised NHWC. Returns NHWC ``pred`` and
        ``emb``, at (H, W) in f32, or at 1/4 resolution in the compute dtype
        when ``upsample`` is False. ``mc_dropout_on``: a committee member's
        forward (dropouts on in eval mode)."""
        high, low = self.backbone(x.permute(0, 3, 1, 2), mc_dropout_on)
        a = self.aspp(high, mc_dropout_on)
        ll = self.low_level_conv(low)
        a = resize_align_corners(_nhwc(a), ll.shape[2:]).permute(0, 3, 1, 2)
        h = torch.cat([a, ll], dim=1)  # [256 | 48] (deeplab.py:50)
        emb, pred = self.seg_head(h, mc_dropout_on)
        if not upsample:
            return {"pred": _nhwc(pred), "emb": _nhwc(emb)}
        out_hw = x.shape[1:3]
        return {
            "pred": resize_align_corners(_nhwc(pred).float(), out_hw),
            "emb": resize_align_corners(_nhwc(emb).float(), out_hw),
        }
