"""Space-to-depth (s2d) rewrite of the early MobileNetV2 blocks: exact.

Counterpart of ``pixelpick_tpu/ops/s2d.py`` (``--s2d_backbone``). s2d(2)
packs each 2x2 spatial cell into channels (C -> 4C), and every op of an
inverted-residual block has an exact s2d-space equivalent at the original
operation count:

- 1x1 conv -> a phase-batched matmul (:func:`conv_s2d_1x1`): the 4 phases
  are independent batch rows of one product;
- depthwise 3x3 -> 9 shifted multiply-adds per output phase
  (:func:`conv_s2d_dw`), each tap a slice of the cell-padded tensor, its
  cell shift and source phase from :func:`_tap_map`;
- BatchNorm -> phase-grouped moments (``models/s2d_block.py``);
- the reference's pad before the block is kept: the pad taps read the zero
  cell padding, and the taps that read the rim's relu6(BN(0)) values are
  restored by ``rho * border_weight_map``.

Layout: tensors are NCHW, in ``channels_last`` memory as the model keeps
them; the s2d channel index is phase-major, ``(py*2 + px)*C + c``, the JAX
package's last axis, so ``to_s2d(x)`` is JAX's ``to_s2d`` of the NHWC view,
transposed. Each function works on the NHWC view (``permute(0, 2, 3, 1)``),
the JAX package's arithmetic op for op, and returns an NCHW view of an
NHWC-contiguous result.

Under ``--spatial_query_sharding`` the cell convs read the cells between
stripes from the other ranks (``parallel/halo.py``) and the rim stays zero
at the image's edges only, where the border map puts ``rho``.

The JAX package computes all of this outside any Pallas kernel, in plain
``jnp``/``lax``, so it is plain tensor math here too; autograd gives the
backward.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pixelpick_tpu_torch.parallel import halo, mesh


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), phase-major ((py*2+px)*C + c)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"to_s2d needs an even height and width: {h}x{w}")
    shard = mesh.current_height_shard()
    if shard is not None:
        # the cell rows of a stripe at level s must be the level-2s stripe,
        # where pad_rows looks for the cell convs' halo
        s = shard.level(h)
        lo, hi = shard.rows_at(s)
        if shard.rows_at(2 * s) != (lo // 2, hi // 2):
            raise AssertionError(
                f"the cells of rows [{lo}, {hi}) at stride {s} are not the "
                f"stripe {shard.rows_at(2 * s)} at stride {2 * s}")
    z = _nhwc(x).reshape(b, h // 2, 2, w // 2, 2, c)
    z = z.permute(0, 1, 3, 2, 4, 5)  # b, h2, w2, py, px, c
    return _nchw(z.reshape(b, h // 2, w // 2, 4 * c))


def from_s2d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_s2d`."""
    b, c4, h2, w2 = x.shape
    c = c4 // 4
    z = _nhwc(x).reshape(b, h2, w2, 2, 2, c)
    z = z.permute(0, 1, 3, 2, 4, 5)  # b, h2, py, w2, px, c
    return _nchw(z.reshape(b, h2 * 2, w2 * 2, c))


def rep_phase(v: torch.Tensor) -> torch.Tensor:
    """Per-original-channel vector (..., C) -> phase-major (..., 4C)."""
    return torch.cat([v, v, v, v], dim=-1)


def conv_s2d_1x1(x_s2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pointwise conv in s2d space: (B, 4Cin, h, w) and w (Cin, Cout) ->
    (B, 4Cout, h, w). Phase-batched: the original operation count on a
    4x-taller product."""
    b, _, h2, w2 = x_s2d.shape
    cin, cout = w.shape
    z = _nhwc(x_s2d).reshape(b, h2, w2, 4, cin)
    y = torch.matmul(z, w)
    return _nchw(y.reshape(b, h2, w2, 4 * cout))


def _tap_map(p: int, k: int) -> Tuple[int, int]:
    """1-D: original tap position p+k-1 -> (cell shift s, phase q)."""
    pos = p + k - 1
    return pos // 2, pos % 2  # Python floor semantics for pos = -1


def conv_s2d_dw(x_s2d: torch.Tensor, w: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Depthwise 3x3 (fixed_padding semantics) in s2d space.

    stride 1: (B, 4C, h, w) -> (B, 4C, h, w) (s2d layout); stride 2:
    (B, 4C, h, w) -> (B, C, h, w) (normal layout: the stride-2 output grid
    is the cell grid). The zero cell padding is the fixed_padding rim; add
    ``rho * border_weight_map`` where the rim carries nonzero values.
    ``w`` is the (3, 3, C) depthwise kernel.
    """
    b, c4, h2, w2 = x_s2d.shape
    c = c4 // 4
    # cell padding: 1 before each dim always; 1 after only for stride 1
    # (stride-1 output phases py=1 reach cell +1, stride-2 taps reach -1..0);
    # under a height shard the rows between stripes are the other ranks'
    after = 1 if stride == 1 else 0
    x_s2d, (top, bottom) = halo.pad_rows(x_s2d, 2 + after, 1, (1, after))
    xp = F.pad(_nhwc(x_s2d), (0, 0, 1, after, top, bottom))

    def tap(sy, sx, qy, qx):
        q = qy * 2 + qx
        return xp[:, 1 + sy:1 + sy + h2, 1 + sx:1 + sx + w2,
                  q * c:(q + 1) * c]

    def phase_out(py, px):
        acc = None
        for ky in range(3):
            sy, qy = _tap_map(py, ky)
            for kx in range(3):
                sx, qx = _tap_map(px, kx)
                term = w[ky, kx] * tap(sy, sx, qy, qx)
                acc = term if acc is None else acc + term
        return acc

    if stride == 1:
        return _nchw(torch.cat([phase_out(py, px) for py in range(2)
                                for px in range(2)], dim=-1))
    return _nchw(phase_out(0, 0))


def border_weight_map(w: torch.Tensor, hw, stride: int) -> torch.Tensor:
    """Per-position sum of the depthwise weights whose tap falls on the
    fixed_padding rim of an ``hw`` input: (1, C, H_out, W_out). ``hw`` is
    the whole map's; under a height shard a rank adds its stripe's rows
    (``halo.stripe``), since the rim lies at the image's edges only.

    The reference pads the block input, so for t>1 blocks the depthwise
    conv's rim taps read relu6(BN(0)) = rho, not zero. The s2d cell conv
    treats the rim as zero; adding ``rho * border_weight_map`` restores the
    exact values. Computed as the total kernel weight minus a conv of ones
    (the taps inside the real region cancel), so edges and corners come out
    right by themselves.
    """
    h, w_ = hw
    c = w.shape[-1]
    # fixed_padding for k=3, d=1 is (1,1)/(1,1) (layers.fixed_padding_amounts)
    ones = torch.ones((1, c, h, w_), dtype=w.dtype, device=w.device)
    inside = F.conv2d(F.pad(ones, (1, 1, 1, 1)), w.permute(2, 0, 1)[:, None],
                      None, stride, 0, 1, c)
    total = w.sum((0, 1))
    return total[None, :, None, None] - inside
