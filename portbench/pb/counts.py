"""Operations and bytes, from the configuration's shapes.

These count the work, not what one implementation does: a multiply-add
is two operations, each input byte is read once and each output byte
written once.

- :func:`forward_flops`: the convolutions and matrix products of one
  image's forward through the configuration's network (BatchNorm,
  activations and resizes left out, a few per cent at most); training
  counts three forwards' worth (the forward, and the backward's data and
  weight gradients), with no recomputation.
- :func:`fused_blocks`: the stride-1 expansion-6 MobileNetV2 blocks of a
  training update, and each one's forward and backward work. The forward's
  operations are ``ops/fused_ir.py:block_flops`` of the port (the 1x1
  expansion over the block's fixed-padded input, 9 multiply-adds per hidden
  value, the projection), and its bytes those of ``chip_smoke.py:1126``;
  the backward's bytes are its inputs (x, dy, the nine weights, the
  BatchNorm moments) and its outputs (dx and the nine gradients), not the
  forward's saved activations that ``chip_smoke.py:1130-1133`` counts.
- :func:`depthwise_work`: a stride-1 depthwise 3x3 over a padded input
  (``chip_smoke.py:459-464``).
- :func:`least_seconds`: the larger of operations over the peak rate and
  bytes over the peak bandwidth.
"""

from __future__ import annotations

from typing import List, Tuple

from reference.nets import (
    FPN_CHAINS, RESNET50_DEPTHS, mv2_plan, resnet_plan,
)

F32 = 4


def _conv(h, w, cin, cout, k, groups=1) -> int:
    return 2 * h * w * cout * (cin // groups) * k * k


def _out(n, k, s, p, d=1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def deeplab_flops(cfg, hw) -> int:
    h, w = _out(hw[0], 3, 2, 1), _out(hw[1], 3, 2, 1)
    stem = int(32 * cfg["width_multiplier"])
    total = _conv(h, w, 3, stem, 3)
    plan, high = mv2_plan(cfg["output_stride"], cfg["width_multiplier"])
    low_hw = None
    for i, (cin, cout, s, d, t) in enumerate(plan):
        hid = cin * t
        hp, wp = h + 2 * d, w + 2 * d
        if t != 1:
            total += _conv(hp, wp, cin, hid, 1)
        h, w = _out(hp, 3, s, 0, d), _out(wp, 3, s, 0, d)
        total += _conv(h, w, hid, hid, 3, groups=hid) + _conv(h, w, hid,
                                                              cout, 1)
        if i == 2:
            low_hw, low_c = (h, w), cout
    total += _conv(h, w, high, 256, 1) + 3 * _conv(h, w, high, 256, 3)
    total += _conv(1, 1, high, 256, 1) + _conv(h, w, 1280, 256, 1)
    lh, lw = low_hw
    total += _conv(lh, lw, low_c, 48, 1) + _conv(lh, lw, 304, 256, 3)
    total += _conv(lh, lw, 256, 256, 3) + _conv(lh, lw, 256,
                                                cfg["n_classes"], 1)
    return total


def fpn_flops(cfg, hw) -> int:
    wm = cfg["width_multiplier"]
    h, w = _out(hw[0], 7, 2, 3), _out(hw[1], 7, 2, 3)
    cin = int(64 * wm)
    total = _conv(h, w, 3, cin, 7)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    levels = []
    for li, (n, (stride, _d, _fd)) in enumerate(
            zip(RESNET50_DEPTHS, resnet_plan(cfg["dilate_scale"])), 1):
        planes = int(64 * 2 ** (li - 1) * wm)
        for bi in range(n):
            s = stride if bi == 0 else 1
            total += _conv(h, w, cin, planes, 1)
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            total += _conv(ho, wo, planes, planes, 3)
            total += _conv(ho, wo, planes, planes * 4, 1)
            if bi == 0 and (s != 1 or cin != planes * 4):
                total += _conv(ho, wo, cin, planes * 4, 1)
            h, w, cin = ho, wo, planes * 4
        levels.append((h, w, cin))
    for (lh, lw, c), n in zip(reversed(levels), FPN_CHAINS):
        total += _conv(lh, lw, c, 256, 1)
        for b in range(n):
            total += _conv(lh, lw, 256 if b == 0 else 128, 128, 3)
            lh, lw = 2 * lh, 2 * lw
    return total + _conv(hw[0], hw[1], 128, cfg["n_classes"], 1)


def forward_flops(cfg, hw) -> int:
    """One image's forward at ``hw``."""
    fn = {"deeplab": deeplab_flops, "fpn": fpn_flops}[cfg["network"]]
    return fn(cfg, hw)


def train_flops(cfg, hw) -> int:
    """One image's forward and backward at ``hw``, no recomputation."""
    return 3 * forward_flops(cfg, hw)


def fused_shapes(cfg, hw) -> List[Tuple[int, int, int, int, int]]:
    """(H, W, Cin, Cout, dilation) of the stride-1 expansion-6 blocks, in
    order, for an input of ``hw``."""
    h, w = _out(hw[0], 3, 2, 1), _out(hw[1], 3, 2, 1)
    out = []
    plan, _ = mv2_plan(cfg["output_stride"], cfg["width_multiplier"])
    for cin, cout, s, d, t in plan:
        if s == 1 and t != 1:
            out.append((h, w, cin, cout, d))
        h, w = _out(h + 2 * d, 3, s, 0, d), _out(w + 2 * d, 3, s, 0, d)
    return out


def fused_block_work(b, h, w, cin, cout, d, groups=1):
    """(forward ops, forward bytes, backward ops, backward bytes) of one
    f32 fused block call on a batch of ``b``."""
    ch = 6 * cin
    hp, wp = h + 2 * d, w + 2 * d
    fwd = 2 * b * hp * wp * cin * ch + 18 * b * h * w * ch \
        + 2 * b * h * w * ch * cout
    weights = (cin * ch + 9 * ch + ch * cout + 4 * ch + 2 * cout) * F32
    moments = groups * (4 * ch + 2 * cout) * F32
    x, y = b * h * w * cin * F32, b * h * w * cout * F32
    fwd_bytes = x + y + weights + moments
    bwd_bytes = 2 * x + y + 2 * weights + moments
    return fwd, fwd_bytes, 2 * fwd, bwd_bytes


def depthwise_work(b, h, w, c, d):
    """(ops, bytes) of a stride-1 depthwise 3x3 at dilation ``d`` producing
    (b, h, w, c) from the padded (b, h + 2d, w + 2d, c)."""
    y = b * h * w * c
    return 18 * y, ((b * (h + 2 * d) * (w + 2 * d) * c) + 9 * c + y) * F32


def first_depthwise(cfg, hw):
    """(H, W, C, dilation) of block 0's stride-1 depthwise, the one that
    the port's kernel runs in an evaluation forward under ``--fused_ir``."""
    h, w = _out(hw[0], 3, 2, 1), _out(hw[1], 3, 2, 1)
    plan, _ = mv2_plan(cfg["output_stride"], cfg["width_multiplier"])
    cin, _cout, s, d, t = plan[0]
    assert s == 1 and t == 1
    return h, w, cin, d


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["f32_flops"], nbytes / peaks["hbm_bytes_per_s"])
