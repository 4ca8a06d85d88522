"""Build the port's CUDA kernels and bind them with ctypes.

Every ``vilbert_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
into ONE shared library with a plain C interface. No source includes
PyTorch's headers, so the build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` spends. The library lands in
``build/vilbert_tpu_torch/`` at the root of the checkout, named by a hash of
the sources and flags: an edited source builds a new library, an unchanged
one loads the library built before.

The build runs at first use (``load_library()``), never at import: the CPU
tests import every module of the package on machines without ``nvcc``.
Callers pass tensors' ``data_ptr()`` and
``torch.cuda.current_stream().cuda_stream`` as Python ints; every pointer and
the stream are declared ``c_void_p`` so that ctypes does not cut them to
32 bits. Each entry point returns a ``cudaError_t``; ``check`` raises on any
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vilbert_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: entry point -> argtypes (all return a cudaError_t as int)
_SIGNATURES = {
    # q, k, v, bias, out, dtype, batch, heads, head_dim, sq, sk,
    # q/k/v batch and row strides, bias batch stride, scale, stream
    "vt_attention_fwd": [_P] * 5 + [_I] * 6 + [_LL] * 7 + [_F, _P],
    # x, residual, weight, bias, out, dtype, rows, h, eps, stream
    "vt_layer_norm_fwd": [_P] * 5 + [_I] * 3 + [_F, _P],
}

#: dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of vilbert_tpu_torch are built from source"
        )
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvilbert_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().vt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
