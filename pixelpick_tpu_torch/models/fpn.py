"""FPN segmentation model on a dilated ResNet.

Counterpart of ``pixelpick_tpu/models/fpn.py`` (reference
``networks/model.py:6 FPNSeg``, ``networks/decoders.py:6-101``):

  encoder: ResNet at ``dilate_scale`` 8 -> [c2, c3, c4, c5] at strides
           4/8/8/8
  decoder: 1x1 laterals with bias to 256 channels; top-down p5 -> p4 ->
           p3 -> p2, each the bilinear (half-pixel) resize of the level
           above to its lateral's size plus the lateral; chains of 3/3/3/2
           UpsampleBlocks (3x3 conv 128 with bias, GroupNorm(32), ReLU, x2
           bilinear half-pixel) bring every level to the input resolution;
           ``emb = p2 + p3 + p4 + p5`` and a 1x1 classifier with bias

There is no final upsample: the chains land at the input resolution, so
``pred`` and ``emb`` are full resolution, in f32, whatever ``upsample``
asks. Under ``dilate_scale`` 0 (``--use_dilated_resnet false``) the four
levels reach different sizes, and the JAX model fails on their sum
(``fpn.py:74``); this one raises there too, naming the sizes.

GroupNorm has flax's arithmetic: f32 statistics with the fast variance
``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) * scale) +
bias``, and an f32 result in both compute dtypes (flax promotes the bf16
input with its f32 parameters). Under a height shard
(``--spatial_query_sharding``) its per-image sums of x and x^2 are the
stripes' f64 sums added over the ranks, and the 3x3 convs and the x2
resizes take their halo rows in ``models/layers.py`` and ``ops/resize.py``.
Module names are the reference's torch
layout (``encoder.base.*``, ``decoder.lat_layer_{i}``,
``decoder.upsample_blocks_{c}.{b}.block.{0,1}``, ``decoder.classifier``),
which the JAX package's ``convert_fpnseg`` reads. The model takes and
returns NHWC; inside it runs NCHW in ``channels_last`` memory format.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from pixelpick_tpu_torch.models.layers import conv
from pixelpick_tpu_torch.models.resnet import ResNetBackbone, stage_channels
from pixelpick_tpu_torch.ops.resize import resize_bilinear
from pixelpick_tpu_torch.parallel import halo

CHAINS = (3, 3, 3, 2)  # upsample blocks on p5, p4, p3, p2


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Half-pixel bilinear resize of an NCHW tensor (``ops/resize.py``)."""
    return _nchw(resize_bilinear(_nhwc(x), hw, align_corners=False))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon)`` on NCHW input; scale 1,
    bias 0 at init. Returns f32."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.float()
        xg = xf.reshape(b, g, c // g, h, w)
        mu = halo.mean(xg, (2, 3, 4), axis=3)
        mu2 = halo.mean(xg * xg, (2, 3, 4), axis=3)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mu = mu.repeat_interleave(c // g, 1)[..., None, None]
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, 1) \
            * self.weight
        return (xf - mu) * mul[..., None, None] \
            + self.bias.view(1, -1, 1, 1)


class UpsampleBlock(nn.Module):
    """3x3 conv with bias -> GroupNorm(32) -> ReLU -> x2 bilinear
    (``fpn.py:32-43``)."""

    def __init__(self, in_ch: int, out_ch: int = 128, dtype=torch.float32):
        super().__init__()
        self.block = nn.Sequential(
            conv(in_ch, out_ch, 3, padding=1, bias=True, dtype=dtype),
            GroupNorm(32, out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        return _resize(h, (h.shape[2] * 2, h.shape[3] * 2))


class FPNDecoder(nn.Module):
    def __init__(self, n_classes: int, in_channels, dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(reversed(in_channels)):  # c5, c4, c3, c2
            setattr(self, f"lat_layer_{i}",
                    conv(c, 256, 1, bias=True, dtype=dtype))
        for i, n in enumerate(CHAINS):
            setattr(self, f"upsample_blocks_{i}", nn.Sequential(*[
                UpsampleBlock(256 if b == 0 else 128, 128, dtype)
                for b in range(n)]))
        self.classifier = conv(128, n_classes, 1, bias=True, dtype=dtype)

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        c2, c3, c4, c5 = feats
        p = [self.lat_layer_0(c5)]
        for i, c in ((1, c4), (2, c3), (3, c2)):
            lat = getattr(self, f"lat_layer_{i}")(c)
            p.append(_resize(p[-1], lat.shape[2:]) + lat)
        levels = [getattr(self, f"upsample_blocks_{i}")(x)
                  for i, x in enumerate(p)]
        sizes = {tuple(x.shape[2:]) for x in levels}
        if len(sizes) != 1:
            raise ValueError(
                f"the FPN levels reach sizes {sorted(sizes)}, which do not "
                "add: the decoder's 3/3/3/2 upsample chains need the "
                "dilated encoder (strides 4/8/8/8, --use_dilated_resnet "
                "true), as in the JAX package")
        p5, p4, p3, p2 = levels
        emb = p2 + p3 + p4 + p5
        return {"emb": emb, "pred": self.classifier(emb)}


class _Encoder(nn.Module):
    """Holds the backbone under ``base``, as the reference's ``Encoder``."""

    def __init__(self, **kw):
        super().__init__()
        self.base = ResNetBackbone(**kw)

    def forward(self, x: torch.Tensor):
        return self.base(x)


class FPNSeg(nn.Module):
    def __init__(self, n_classes: int, n_layers: int = 50,
                 width_multiplier: float = 1.0, dilate_scale: int = 8,
                 dtype=torch.float32, bn_groups: int = 0):
        super().__init__()
        self.encoder = _Encoder(n_layers=n_layers, dilate_scale=dilate_scale,
                                width_multiplier=width_multiplier,
                                dtype=dtype, bn_groups=bn_groups)
        self.decoder = FPNDecoder(
            n_classes, stage_channels(n_layers, width_multiplier), dtype)
        # the encoder's total stride: the height shard's unit
        self.total_stride = {8: 8, 16: 16}.get(dilate_scale, 32)

    def set_dropout_generator(self,
                              generator: Optional[torch.Generator]) -> None:
        """The driver and the selector install the round's dropout stream;
        the FPN has no dropout site, so there is nothing to set."""

    def forward(self, x: torch.Tensor, upsample: bool = True,
                mc_dropout_on: bool = False) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalised NHWC. Returns NHWC ``pred`` and
        ``emb`` at the input resolution in f32; both keywords are accepted
        and change nothing, as in the JAX model."""
        out = self.decoder(self.encoder(_nchw(x)))
        return {"pred": _nhwc(out["pred"]).float(),
                "emb": _nhwc(out["emb"]).float()}
