"""Depthwise 3x3 convolution: the hand-written Hopper kernel and its plain
version.

Counterpart of ``pixelpick_tpu/ops/depthwise.py``. The TPU kernel
``_dw_halo_kernel`` becomes ``csrc/depthwise.cu`` (a CUDA C++ kernel for
``sm_90a``; see the note at the top of that file for what bounds it and how
it is laid out). It is compiled with ``nvcc`` at first use
(``ops/build.py``) and bound through ``ctypes`` to a plain C function.

Dispatch of :func:`depthwise_conv3x3`, the same as the JAX function's:

- stride 2 goes to a grouped convolution (``F.conv2d``), as the JAX package
  sends it to XLA's grouped conv (``pixelpick_tpu/ops/depthwise.py:117-122``).
  It is counted on its own counter;
- stride 1 on a CUDA tensor launches the kernel, or raises;
- stride 1 on a CPU tensor runs :func:`depthwise_reference_torch`, the plain
  PyTorch version of the kernel (the tests run it; a card is not needed).

The stride-1 path is a ``torch.autograd.Function`` with the JAX package's
custom VJP (``pixelpick_tpu/ops/depthwise.py:178-220``): dx is a stride-1
depthwise conv of the gradient padded by 2d with the spatially flipped taps,
which the same kernel computes (a second launch, counted on ``kernel_dx``);
dw is the per-tap f32 reduction, plain PyTorch as the JAX package leaves it
to XLA. Stride 2 keeps the grouped conv and its autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pixelpick_tpu_torch.ops.build import load_library
from pixelpick_tpu_torch.parallel import halo

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches made by the wrappers below, so that a run can show which path it
# took: "kernel" counts the hand-written kernel in the forward, "kernel_dx"
# the same kernel computing dx in the backward, "stride2_conv" the grouped
# convolutions of the stride-2 blocks.
launch_counts = {"kernel": 0, "kernel_dx": 0, "stride2_conv": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    sig = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p]
    return load_library("depthwise", {"pp_dw3x3_s1_nhwc": (sig, ctypes.c_int)})


def depthwise_reference_torch(x: torch.Tensor, w: torch.Tensor,
                              dilation: int = 1) -> torch.Tensor:
    """The plain version of the kernel: x (B, H+2d, W+2d, C) pre-padded
    NHWC, w (3, 3, C); VALID, stride 1. Nine shifted multiply-adds in f32,
    in the kernel's tap order; the result in ``x.dtype``."""
    d = dilation
    ho, wo = x.shape[1] - 2 * d, x.shape[2] - 2 * d
    xf, wf = x.float(), w.float()
    acc = None
    for ky in range(3):
        for kx in range(3):
            tap = xf[:, ky * d:ky * d + ho, kx * d:kx * d + wo, :] * wf[ky, kx]
            acc = tap if acc is None else acc + tap
    return acc.to(x.dtype)


def _launch_kernel(x: torch.Tensor, w: torch.Tensor, dilation: int,
                   counter: str = "kernel") -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the depthwise kernel runs on CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the depthwise kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"w ({w.dtype}, {w.device}) must match x "
                        f"({x.dtype}, {x.device})")
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1]):
        raise ValueError(f"x must be (B, H, W, C) and w (3, 3, C); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the depthwise kernel takes contiguous NHWC x and "
                         "contiguous (3, 3, C) w")
    b, hp, wp, c = x.shape
    ho, wo = hp - 2 * dilation, wp - 2 * dilation
    if dilation < 1 or ho <= 0 or wo <= 0:
        raise ValueError(f"input {tuple(x.shape)} is too small for a 3x3 "
                         f"window at dilation {dilation}")
    y = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _library().pp_dw3x3_s1_nhwc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 _DTYPE_CODES[x.dtype], b, hp, wp, c, dilation, stream)
    if err != 0:
        raise RuntimeError(f"depthwise kernel launch failed: CUDA error "
                           f"{err} for x {tuple(x.shape)} {x.dtype}, "
                           f"dilation {dilation}")
    launch_counts[counter] += 1
    return y


def grouped_conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
                      dilation: int) -> torch.Tensor:
    """VALID depthwise 3x3 through the library's grouped convolution, on
    NHWC x and (3, 3, C) w; returns an NHWC view. Uncounted here:
    ``_dw_forward`` counts its stride-2 calls, and a yardstick that times
    the library calls it directly."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
                 stride=stride, dilation=dilation, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def _dw_s1(x: torch.Tensor, w: torch.Tensor, dilation: int,
           counter: str = "kernel") -> torch.Tensor:
    """Stride-1 VALID depthwise conv: the plain version for a CPU tensor,
    the kernel (or an error) for a CUDA tensor."""
    if x.device.type == "cpu":
        return depthwise_reference_torch(x, w, dilation)
    return _launch_kernel(x, w, dilation, counter)


def depthwise_wgrad(x: torch.Tensor, g: torch.Tensor,
                    dilation: int) -> torch.Tensor:
    """dw of the stride-1 VALID conv: per tap, the f32 sum over batch and
    space of the shifted input times the output gradient; (3, 3, C) f32."""
    d = dilation
    ho, wo = g.shape[1], g.shape[2]
    gf = g.float()
    taps = [(x[:, ky * d:ky * d + ho, kx * d:kx * d + wo, :].float() * gf)
            .sum((0, 1, 2)) for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, -1)


class _DepthwiseS1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return _dw_s1(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gp = F.pad(g, (0, 0, 2 * d, 2 * d, 2 * d, 2 * d)).contiguous()
            dx = _dw_s1(gp, w.flip(0, 1).contiguous(), d, "kernel_dx")
        if ctx.needs_input_grad[1]:
            dw = depthwise_wgrad(x, g, d).to(w.dtype)
        return dx, dw, None


def _dw_forward(x: torch.Tensor, w: torch.Tensor, stride: int,
                dilation: int) -> torch.Tensor:
    """x: (B, H, W, C) pre-padded NHWC; w: (3, 3, C). VALID depthwise conv."""
    if stride != 1:
        launch_counts["stride2_conv"] += 1
        return grouped_conv_nhwc(x, w, stride, dilation)
    return _DepthwiseS1.apply(x, w, dilation)


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      dilation: int = 1, padding: int = 1) -> torch.Tensor:
    """Depthwise 3x3 conv, NHWC, symmetric ``padding``; w: (3, 3, C).
    Under a height shard (``parallel/mesh.py:sharded_height``) ``x`` is a
    row stripe: the pad rows between stripes are the neighbours' rows
    (``parallel/halo.py``), so the kernel's pre-padded input carries the
    halo; at stride 2 only the top one is read."""
    x, (pad_h, _) = halo.pad_rows(x, 2 * dilation + 1, stride, padding, axis=1)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, pad_h, pad_h)).contiguous()
    return _dw_forward(x, w, stride, dilation)
