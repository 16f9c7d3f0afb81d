"""Bilinear resize with exact torch semantics, as interpolation matmuls.

Counterpart of ``pixelpick_tpu/ops/resize.py``: bilinear resize is separable
linear interpolation, so a dense ``(out, in)`` row-interpolation matrix per
axis is built once on the host and applied as two matrix products, in f32
whatever the input dtype. ``align_corners=True`` is the DeepLab path
(``s = d * (in - 1) / (out - 1)``); ``False`` is half-pixel
(``s = (d + 0.5) * in / out - 0.5``).

The sparse-coordinate gather variants serve only the training loss and come
with the training slice.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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


def interp_matrix(in_size: int, out_size: int, align_corners: bool,
                  device) -> torch.Tensor:
    return torch.from_numpy(
        _interp_matrix_np(in_size, out_size, align_corners)).to(device)


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
    ah = interp_matrix(h, oh, align_corners, x.device)
    aw = interp_matrix(w, ow, align_corners, x.device)
    y = torch.einsum("oh,bhwc->bowc", ah, x.float())
    y = torch.einsum("pw,bowc->bopc", aw, y)
    y = y.to(x.dtype).contiguous()
    return y[0] if squeeze else y


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    return resize_bilinear(x, out_hw, align_corners=True)
