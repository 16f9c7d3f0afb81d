"""Bilinear resize with exact torch semantics, as interpolation matmuls.

Counterpart of ``pixelpick_tpu/ops/resize.py``: bilinear resize is separable
linear interpolation, so a dense ``(out, in)`` row-interpolation matrix per
axis is built once on the host and applied as two matrix products, in f32
whatever the input dtype. ``align_corners=True`` is the DeepLab path
(``s = d * (in - 1) / (out - 1)``); ``False`` is half-pixel
(``s = (d + 0.5) * in / out - 0.5``).

Under a height shard (``parallel/mesh.py:sharded_height``) ``x`` and the
output are row stripes of their maps: each rank's output rows read the
input rows that its rows of the row matrix touch, some of which another
rank holds (``parallel/halo.py:fetch_rows``); with no shard the row
matrix is the whole one and no row moves.

The sparse-coordinate forms (``gather_bilinear_align_corners``,
``gather_bilinear_matmul``) evaluate the align-corners upsampling at the
labelled pixels only, for the sparse training loss; by linearity they equal
upsample-then-index exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pixelpick_tpu_torch.parallel import halo


@lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) bilinear interpolation matrix, f32."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    d = np.arange(out_size, dtype=np.float64)
    if align_corners:
        s = d * (in_size - 1) / (out_size - 1) if out_size > 1 else np.zeros_like(d)
    else:
        s = np.clip((d + 0.5) * in_size / out_size - 0.5, 0.0, in_size - 1)
    lo = np.floor(s).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2) if in_size > 1 else lo
    frac = s - lo
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    mat[rows, lo] = 1.0 - frac
    if in_size > 1:
        mat[rows, lo + 1] += frac
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def _interp_matrix_on(in_size: int, out_size: int, align_corners: bool,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _interp_matrix_np(in_size, out_size, align_corners)).to(device)


def interp_matrix(in_size: int, out_size: int, align_corners: bool,
                  device) -> torch.Tensor:
    """The matrix on ``device``, uploaded once and cached: a blocking
    upload waits for the device, so one per call would stall the host on
    every forward. Callers must not write to it."""
    return _interp_matrix_on(in_size, out_size, align_corners,
                             torch.device(device))


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """Resize NHWC (or HWC) ``x`` to ``out_hw`` with torch bilinear semantics.

    Two matrix products, rows then columns, in f32 regardless of the input
    dtype; the result is cast back to ``x.dtype``. Returns a contiguous
    NHWC tensor.
    """
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x[0] if squeeze else x
    ah, x = _rows(x, oh, align_corners)
    aw = interp_matrix(w, ow, align_corners, x.device)
    y = torch.einsum("oh,bhwc->bowc", ah, x.float())
    y = torch.einsum("pw,bowc->bopc", aw, y)
    y = y.to(x.dtype).contiguous()
    return y[0] if squeeze else y


@lru_cache(maxsize=None)
def _rows_read(in_size: int, out_bounds: tuple, align_corners: bool):
    """Each rank's input rows ``(a, b)`` that its output rows
    ``out_bounds[q]:out_bounds[q + 1]`` of the row matrix read."""
    mat = _interp_matrix_np(in_size, out_bounds[-1], align_corners)
    needs = []
    for q in range(len(out_bounds) - 1):
        cols = np.nonzero(mat[out_bounds[q]:out_bounds[q + 1]].any(0))[0]
        needs.append((int(cols[0]), int(cols[-1]) + 1))
    return tuple(needs)


def _rows(x: torch.Tensor, oh: int, align_corners: bool):
    """The row matrix's block for this rank's ``oh`` output rows and the
    input rows it reads (``halo.fetch_rows``: under a height shard some
    are another rank's; with none, the whole matrix and ``x``)."""
    h = halo.bounds(x.shape[1])[0][-1]
    out, r = halo.bounds(oh)
    needs = _rows_read(h, out, align_corners)
    a, b = needs[r]
    ah = interp_matrix(h, out[-1], align_corners, x.device)
    return ah[out[r]:out[r + 1], a:b], halo.fetch_rows(x, needs, axis=1)


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    return resize_bilinear(x, out_hw, align_corners=True)


def _src(d: torch.Tensor, in_size: int, out_size: int):
    """Source row/column (floor, clipped to in_size - 2) and fraction of
    full-resolution coordinates ``d`` under align-corners, in f32."""
    if out_size == 1 or in_size == out_size:
        scale = 1.0 if in_size == out_size else 0.0
    else:
        scale = (in_size - 1) / (out_size - 1)
    s = d.float() * scale
    lo = torch.floor(s).long().clamp(0, max(in_size - 2, 0))
    return lo, s - lo.float()


def gather_bilinear_align_corners(feat: torch.Tensor, coords_yx: torch.Tensor,
                                  full_hw) -> torch.Tensor:
    """The align-corners upsampling of ``feat`` (B, h, w, C) at integer
    full-resolution coordinates ``coords_yx`` (B, K, 2), by four gathers per
    point; (B, K, C) f32 (``resize.py:86-140``)."""
    bsz, h, w, _ = feat.shape
    feat = feat.float()
    ylo, yfrac = _src(coords_yx[..., 0], h, int(full_hw[0]))
    xlo, xfrac = _src(coords_yx[..., 1], w, int(full_hw[1]))
    yhi = (ylo + 1).clamp(max=h - 1)
    xhi = (xlo + 1).clamp(max=w - 1)
    flat = feat.reshape(bsz, h * w, -1)

    def take(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx)

    wy, wx = yfrac[..., None], xfrac[..., None]
    top = take(ylo, xlo) * (1 - wx) + take(ylo, xhi) * wx
    bot = take(yhi, xlo) * (1 - wx) + take(yhi, xhi) * wx
    return top * (1 - wy) + bot * wy


def gather_bilinear_matmul(feat: torch.Tensor, coords_yx: torch.Tensor,
                           full_hw) -> torch.Tensor:
    """Same contract, as separable one-hot selection products: a (B, K, h)
    row selection and a (B, K, w) column selection with two nonzero weights
    each, so the backward is a product too (``resize.py:143-190``). At
    h == 1 (or lo == hi at the border) both terms hit the same row and the
    weights still sum to 1."""
    _, h, w, _ = feat.shape
    ylo, yfrac = _src(coords_yx[..., 0], h, int(full_hw[0]))
    xlo, xfrac = _src(coords_yx[..., 1], w, int(full_hw[1]))
    yhi = (ylo + 1).clamp(max=h - 1)
    xhi = (xlo + 1).clamp(max=w - 1)
    rows = torch.arange(h, device=feat.device)
    cols = torch.arange(w, device=feat.device)
    sel_y = ((rows == ylo[..., None]) * (1 - yfrac)[..., None]
             + (rows == yhi[..., None]) * yfrac[..., None])
    sel_x = ((cols == xlo[..., None]) * (1 - xfrac)[..., None]
             + (cols == xhi[..., None]) * xfrac[..., None])
    tmp = torch.einsum("bkh,bhwc->bkwc", sel_y.float(), feat.float())
    return torch.einsum("bkw,bkwc->bkc", sel_x.float(), tmp)
