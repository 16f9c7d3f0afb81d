"""Building and loading the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into
``build/kernels/`` at the repository root, and loaded with ``ctypes``; no
PyTorch headers are compiled, so a build takes seconds. The library is
cached by the hash of its source and flags. The compiler's output
(``-Xptxas -v``: registers, spills) is kept beside it in a ``.log`` file.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, for its current content."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpp_{name}_{digest}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` once per source content; return the path."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, its functions typed from
    ``signatures``: {function: (argtypes, restype)}."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build_library(name)))
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        _libs[name] = lib
    return _libs[name]


def build_all(names) -> Dict[str, Path]:
    """Build several sources at once, one ``nvcc`` process each, all started
    together; return their paths. Raises if any build fails."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build_library, names)))
