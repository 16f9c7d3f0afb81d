"""DeepLabv3+ on MobileNetV2 and the semantic FPN on a dilated ResNet-50,
as plain functions of a weight dict.

The parameter names are those of the original PixelPick repository's torch
modules (``networks/deeplab.py``, ``networks/mobilenet_v2.py``,
``networks/aspp.py``, ``networks/decoders.py``, ``networks/model.py``), so
one dict of tensors serves the reference and the program's
``load_state_dict``. Each network follows its publication:

- MobileNetV2 (arXiv:1801.04381) with the DeepLab output-stride schedule
  and TF-style fixed padding of each block's input before its 1x1
  expansion; DeepLabv3+ (arXiv:1802.02611): ASPP at rates 6/12/18, the 1/4
  low-level branch, two 3x3 head convs with dropouts 0.5 and 0.2;
- ResNet-50 (arXiv:1512.03385), v1 bottlenecks with the stride on the 3x3,
  dilated to output stride 8 (layer3 dilation 2, layer4 dilation 4, each
  stage's first 3x3 at half the dilation); the semantic FPN decoder
  (arXiv:1901.02446): 1x1 laterals to 256, top-down sums, 3/3/3/2
  upsampling blocks (3x3 conv 128, GroupNorm 32, ReLU, x2 bilinear) summed
  at full resolution and a 1x1 classifier.

BatchNorm in training normalises by the batch's moments (biased variance),
in evaluation by the running statistics. Dropout keeps each value with
probability 1 - p and draws one ``torch.rand`` of the activation's shape per
site, in forward order, from the generator it is given.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

# MobileNetV2's inverted-residual table: (expansion t, channels c, repeats
# n, stride s)
MV2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
RESNET50_DEPTHS = (3, 4, 6, 3)
FPN_CHAINS = (3, 3, 3, 2)
BN_EPS = 1e-5


# ------------------------------ plans ------------------------------

def mv2_plan(output_stride: int, width: float = 1.0):
    """Per block (in, out, stride, dilation, t), and the last width."""
    plan, cin, cur, rate = [], int(32 * width), 2, 1
    for t, c, n, s in MV2_SETTINGS:
        if cur == output_stride:
            stride, dil = 1, rate
            rate *= s
        else:
            stride, dil = s, 1
            cur *= s
        cout = int(c * width)
        for i in range(n):
            plan.append((cin, cout, stride if i == 0 else 1, dil, t))
            cin = cout
    return plan, cin


def resnet_plan(dilate_scale: int = 8):
    """Per stage (stride, dilation, first block's dilation)."""
    plan = [(1, 1, 1), (2, 1, 1), (2, 1, 1), (2, 1, 1)]
    if dilate_scale == 8:
        plan[2], plan[3] = (1, 2, 1), (1, 4, 2)
    elif dilate_scale == 16:
        plan[3] = (1, 2, 1)
    return plan


# ------------------------------ specs ------------------------------
# name -> (shape, kind). kinds: "conv_in" / "conv_out" (He normal, fan-in /
# fan-out), "bias" (zeros), "bn_w" / "bn_b", "gn_w" / "gn_b", and the
# buffers "bn_mean", "bn_var", "bn_count"

def _bn(spec, name, c):
    spec[f"{name}.weight"] = ((c,), "bn_w")
    spec[f"{name}.bias"] = ((c,), "bn_b")
    spec[f"{name}.running_mean"] = ((c,), "bn_mean")
    spec[f"{name}.running_var"] = ((c,), "bn_var")
    spec[f"{name}.num_batches_tracked"] = ((), "bn_count")


def _conv(spec, name, cout, cin, k, kind="conv_in", bias=False):
    spec[f"{name}.weight"] = ((cout, cin, k, k), kind)
    if bias:
        spec[f"{name}.bias"] = ((cout,), "bias")


def deeplab_spec(cfg) -> "OrderedDict[str, tuple]":
    spec = OrderedDict()
    plan, high = mv2_plan(cfg["output_stride"], cfg["width_multiplier"])
    stem = int(32 * cfg["width_multiplier"])
    _conv(spec, "backbone.features.0.0", stem, 3, 3)
    _bn(spec, "backbone.features.0.1", stem)
    for i, (cin, cout, _s, _d, t) in enumerate(plan):
        p = f"backbone.features.{i + 1}.conv"
        hid = int(round(cin * t))
        j = 0
        if t != 1:
            _conv(spec, f"{p}.0", hid, cin, 1)
            _bn(spec, f"{p}.1", hid)
            j = 3
        _conv(spec, f"{p}.{j}", hid, 1, 3)
        _bn(spec, f"{p}.{j + 1}", hid)
        _conv(spec, f"{p}.{j + 3}", cout, hid, 1)
        _bn(spec, f"{p}.{j + 4}", cout)
    for i in range(1, 5):
        _conv(spec, f"aspp.aspp{i}.atrous_conv", 256, high, 1 if i == 1 else 3)
        _bn(spec, f"aspp.aspp{i}.bn", 256)
    _conv(spec, "aspp.global_avg_pool.1", 256, high, 1)
    _bn(spec, "aspp.global_avg_pool.2", 256)
    _conv(spec, "aspp.conv1", 256, 1280, 1)
    _bn(spec, "aspp.bn1", 256)
    low = plan[2][1]
    _conv(spec, "low_level_conv.0", 48, low, 1)
    _bn(spec, "low_level_conv.1", 48)
    _conv(spec, "seg_head.segment_head.0", 256, 256 + 48, 3)
    _bn(spec, "seg_head.segment_head.1", 256)
    _conv(spec, "seg_head.segment_head.4", 256, 256, 3)
    _bn(spec, "seg_head.segment_head.5", 256)
    _conv(spec, "seg_head.classifier", cfg["n_classes"], 256, 1, bias=True)
    return spec


def fpn_spec(cfg) -> "OrderedDict[str, tuple]":
    spec = OrderedDict()
    w = cfg["width_multiplier"]
    stem = int(64 * w)
    _conv(spec, "encoder.base.prefix.conv1", stem, 3, 7, "conv_out")
    _bn(spec, "encoder.base.prefix.bn1", stem)
    cin, chans = stem, []
    for li, (n, (stride, _d, _fd)) in enumerate(
            zip(RESNET50_DEPTHS, resnet_plan(cfg["dilate_scale"])), 1):
        planes = int(64 * 2 ** (li - 1) * w)
        for bi in range(n):
            p = f"encoder.base.layer{li}.{bi}"
            _conv(spec, f"{p}.conv1", planes, cin, 1, "conv_out")
            _bn(spec, f"{p}.bn1", planes)
            _conv(spec, f"{p}.conv2", planes, planes, 3, "conv_out")
            _bn(spec, f"{p}.bn2", planes)
            _conv(spec, f"{p}.conv3", planes * 4, planes, 1, "conv_out")
            _bn(spec, f"{p}.bn3", planes * 4)
            if bi == 0 and (stride != 1 or cin != planes * 4):
                _conv(spec, f"{p}.downsample.0", planes * 4, cin, 1,
                      "conv_out")
                _bn(spec, f"{p}.downsample.1", planes * 4)
            cin = planes * 4
        chans.append(cin)
    for i, c in enumerate(reversed(chans)):
        _conv(spec, f"decoder.lat_layer_{i}", 256, c, 1, bias=True)
    for i, n in enumerate(FPN_CHAINS):
        for b in range(n):
            p = f"decoder.upsample_blocks_{i}.{b}.block"
            _conv(spec, f"{p}.0", 128, 256 if b == 0 else 128, 3, bias=True)
            spec[f"{p}.1.weight"] = ((128,), "gn_w")
            spec[f"{p}.1.bias"] = ((128,), "gn_b")
    _conv(spec, "decoder.classifier", cfg["n_classes"], 128, 1, bias=True)
    return spec


def spec_of(cfg):
    return {"deeplab": deeplab_spec, "fpn": fpn_spec}[cfg["network"]](cfg)


# ------------------------------ layers ------------------------------

class Ctx:
    """What a forward needs besides the weights: training (batch moments,
    dropouts on), the dropout generator, and an optional dict that records
    each BatchNorm's batch moments (to set running statistics from)."""

    def __init__(self, w: Dict[str, torch.Tensor], train: bool,
                 generator: Optional[torch.Generator] = None,
                 record: Optional[dict] = None):
        self.w, self.train, self.gen, self.record = w, train, generator, record

    def bn(self, x, name):
        w = self.w
        if self.train or self.record is not None:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
            if self.record is not None:
                self.record[name] = (mean.detach(), var.detach())
        else:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        return (x - mean[None, :, None, None]) \
            * torch.rsqrt(var + BN_EPS)[None, :, None, None] \
            * w[f"{name}.weight"][None, :, None, None] \
            + w[f"{name}.bias"][None, :, None, None]

    def conv(self, x, name, stride=1, padding=0, dilation=1, groups=1):
        return F.conv2d(x, self.w[f"{name}.weight"],
                        self.w.get(f"{name}.bias"), stride, padding,
                        dilation, groups)

    def dropout(self, x, p):
        if not self.train:
            return x
        u = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(u < 1.0 - p, x / (1.0 - p), torch.zeros_like(x))


def fixed_pad(x, dilation):
    eff = 3 + 2 * (dilation - 1)
    beg = (eff - 1) // 2
    end = eff - 1 - beg
    return F.pad(x, (beg, end, beg, end))


def relu6(x):
    return x.clamp(0.0, 6.0)


# ------------------------------ DeepLab ------------------------------

def deeplab_forward(c: Ctx, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, 3, H, W) normalised. Returns the 1/4-resolution logits
    (B, n_classes, H/4, W/4)."""
    plan, _ = mv2_plan(cfg["output_stride"], cfg["width_multiplier"])
    h = relu6(c.bn(c.conv(x, "backbone.features.0.0", 2, 1),
                   "backbone.features.0.1"))
    low = None
    for i, (cin, cout, stride, d, t) in enumerate(plan):
        p = f"backbone.features.{i + 1}.conv"
        y = fixed_pad(h, d)
        j = 0
        if t != 1:
            y = relu6(c.bn(c.conv(y, f"{p}.0"), f"{p}.1"))
            j = 3
        y = relu6(c.bn(c.conv(y, f"{p}.{j}", stride, 0, d, y.shape[1]),
                       f"{p}.{j + 1}"))
        y = c.bn(c.conv(y, f"{p}.{j + 3}"), f"{p}.{j + 4}")
        h = h + y if stride == 1 and cin == cout else y
        if i == 2:
            low = h
    rates = {16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}[cfg["output_stride"]]
    br = []
    for i, r in enumerate(rates, 1):
        pad = 0 if r == 1 else r
        br.append(F.relu(c.bn(c.conv(h, f"aspp.aspp{i}.atrous_conv", 1, pad,
                                     r), f"aspp.aspp{i}.bn")))
    g = F.relu(c.bn(c.conv(h.mean((2, 3), keepdim=True),
                           "aspp.global_avg_pool.1"),
                    "aspp.global_avg_pool.2"))
    br.append(g.expand_as(br[0]))
    a = F.relu(c.bn(c.conv(torch.cat(br, 1), "aspp.conv1"), "aspp.bn1"))
    a = c.dropout(a, 0.5)
    ll = F.relu(c.bn(c.conv(low, "low_level_conv.0"), "low_level_conv.1"))
    a = F.interpolate(a, size=ll.shape[2:], mode="bilinear",
                      align_corners=True)
    h = torch.cat([a, ll], 1)
    h = F.relu(c.bn(c.conv(h, "seg_head.segment_head.0", 1, 1),
                    "seg_head.segment_head.1"))
    h = c.dropout(h, 0.5)
    h = F.relu(c.bn(c.conv(h, "seg_head.segment_head.4", 1, 1),
                    "seg_head.segment_head.5"))
    h = c.dropout(h, cfg["mc_dropout_p"])
    return c.conv(h, "seg_head.classifier")


# ------------------------------ FPN ------------------------------

def _half_pixel(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def fpn_forward(c: Ctx, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, 3, H, W) normalised. Returns full-resolution logits."""
    h = F.relu(c.bn(c.conv(x, "encoder.base.prefix.conv1", 2, 3),
                    "encoder.base.prefix.bn1"))
    h = F.max_pool2d(h, 3, 2, 1)
    feats = []
    for li, (n, (stride, dil, fdil)) in enumerate(
            zip(RESNET50_DEPTHS, resnet_plan(cfg["dilate_scale"])), 1):
        for bi in range(n):
            p = f"encoder.base.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            d = fdil if bi == 0 else dil
            y = F.relu(c.bn(c.conv(h, f"{p}.conv1"), f"{p}.bn1"))
            y = F.relu(c.bn(c.conv(y, f"{p}.conv2", s, d, d), f"{p}.bn2"))
            y = c.bn(c.conv(y, f"{p}.conv3"), f"{p}.bn3")
            if f"{p}.downsample.0.weight" in c.w:
                h = c.bn(c.conv(h, f"{p}.downsample.0", s),
                         f"{p}.downsample.1")
            h = F.relu(y + h)
        feats.append(h)
    c2, c3, c4, c5 = feats
    p = [c.conv(c5, "decoder.lat_layer_0")]
    for i, f in ((1, c4), (2, c3), (3, c2)):
        lat = c.conv(f, f"decoder.lat_layer_{i}")
        p.append(_half_pixel(p[-1], lat.shape[2:]) + lat)
    emb = 0
    for i, (level, n) in enumerate(zip(p, FPN_CHAINS)):
        for b in range(n):
            q = f"decoder.upsample_blocks_{i}.{b}.block"
            level = F.relu(F.group_norm(c.conv(level, f"{q}.0", 1, 1), 32,
                                        c.w[f"{q}.1.weight"],
                                        c.w[f"{q}.1.bias"], BN_EPS))
            level = _half_pixel(level, (level.shape[2] * 2,
                                        level.shape[3] * 2))
        emb = emb + level
    return c.conv(emb, "decoder.classifier")


def forward(c: Ctx, x: torch.Tensor, cfg) -> torch.Tensor:
    """The configuration's network: logits, NCHW, at 1/4 resolution (the
    DeepLab) or at full resolution (the FPN)."""
    fn = {"deeplab": deeplab_forward, "fpn": fpn_forward}[cfg["network"]]
    return fn(c, x, cfg)


def full_res_logits(c: Ctx, x: torch.Tensor, cfg) -> torch.Tensor:
    """(B, C, H, W) logits at the input's resolution: the DeepLab's 1/4 map
    upsampled bilinearly with aligned corners."""
    out = forward(c, x, cfg)
    if out.shape[2:] != x.shape[2:]:
        out = F.interpolate(out, size=x.shape[2:], mode="bilinear",
                            align_corners=True)
    return out
