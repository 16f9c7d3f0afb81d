"""Depthwise 3x3 convolution: the hand-written Hopper kernel and its plain
version.

Counterpart of ``pixelpick_tpu/ops/depthwise.py``. The TPU kernel
``_dw_halo_kernel`` becomes ``csrc/depthwise.cu`` (a CUDA C++ kernel for
``sm_90a``; see the note at the top of that file for what bounds it and how
it is laid out). It is compiled with ``nvcc`` at first use into
``build/kernels/`` at the repository root and bound through ``ctypes`` to a
plain C function, so no PyTorch headers are compiled.

Dispatch of :func:`depthwise_conv3x3`, the same as the JAX function's:

- stride 2 goes to a grouped convolution (``F.conv2d``), as the JAX package
  sends it to XLA's grouped conv (``pixelpick_tpu/ops/depthwise.py:117-122``).
  It is counted on its own counter;
- stride 1 on a CUDA tensor launches the kernel, or raises;
- stride 1 on a CPU tensor runs :func:`depthwise_reference_torch`, the plain
  PyTorch version of the kernel (the tests run it; a card is not needed).

Forward only: the query path needs no gradient. The backward (the JAX
package's custom VJP) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "depthwise.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches made by the wrappers below, so that a run can show which path it
# took: "kernel" counts the hand-written kernel, "stride2_conv" the grouped
# convolutions of the stride-2 blocks.
launch_counts = {"kernel": 0, "stride2_conv": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "depthwise kernel is built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library() -> Path:
    """Compile ``csrc/depthwise.cu`` into a shared library, once per source
    content, and return its path. The compiler's output (``-Xptxas -v``:
    registers, spills) is kept beside it in a ``.log`` file."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libpp_depthwise_{digest}.so"
    if out.is_file():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC} (exit {proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.pp_dw3x3_s1_nhwc
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _launch_kernel(x: torch.Tensor, w: torch.Tensor,
                   dilation: int) -> torch.Tensor:
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
    launch_counts["kernel"] += 1
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


def _dw_forward(x: torch.Tensor, w: torch.Tensor, stride: int,
                dilation: int) -> torch.Tensor:
    """x: (B, H, W, C) pre-padded NHWC; w: (3, 3, C). VALID depthwise conv."""
    if stride != 1:
        launch_counts["stride2_conv"] += 1
        return grouped_conv_nhwc(x, w, stride, dilation)
    if x.device.type == "cpu":
        return depthwise_reference_torch(x, w, dilation)
    return _launch_kernel(x, w, dilation)


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      dilation: int = 1, padding: int = 1) -> torch.Tensor:
    """Depthwise 3x3 conv, NHWC, symmetric ``padding``; w: (3, 3, C)."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding)).contiguous()
    return _dw_forward(x, w, stride, dilation)
