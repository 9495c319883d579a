"""Build and load the package's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), cached under ``annsearch_tpu_torch/_build/<hash of sources and
flags>/`` and loaded with ``ctypes``. Without ``nvcc`` the build raises:
a CUDA tensor never falls back to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "build_log", "SOURCE_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libannsearch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name → argtypes (every pointer and the stream as
#: c_void_p, so ctypes does not cut them to 32 bits); each returns the
#: launch's cudaError_t
_SIGNATURES = {
    "annsearch_ivf_scan_k1a": [_P] * 10 + [_I] * 6 + [_P],
    "annsearch_ivf_scan_f32": [_P] * 8 + [_I] * 8 + [_P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "cannot be built"
        )
    return nvcc


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build_log() -> str:
    """The compiler's output of the current build (ptxas register and
    shared-memory usage), or "" before the first build."""
    log = _build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = _build_dir()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())],
            capture_output=True, text=True,
        )
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
