"""Build and load the package's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` (one process per
source, all started together, then one link) into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds),
cached under ``annsearch_tpu_torch/_build/<hash of sources and
flags>/`` and loaded with ``ctypes``. Without ``nvcc`` the build raises:
a CUDA tensor never falls back to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = [
    "load_library", "build_log", "kernel_resources", "mma_counts", "mma_sync_once",
    "wgmma_once", "SOURCE_DIR", "BUILD_DIR",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libannsearch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the stream, then nblk, nq1, scratch and its bytes
_K1_TAIL = [_P, _I, _I, _P, ctypes.c_size_t]
#: C entry points: name → argtypes (every pointer and the stream as
#: c_void_p, so ctypes does not cut them to 32 bits); each returns the
#: launch's cudaError_t
_SIGNATURES = {
    # the K1 entries end with the blocks of `cells` (the tensor map's
    # extent), the rows of `queries` and the wide rows' query-term scratch
    "annsearch_ivf_scan_k1a": [_P] * 10 + [_I] * 7 + _K1_TAIL,
    "annsearch_ivf_scan_k1b_l2": [_P] * 10 + [_I] * 7 + _K1_TAIL,
    "annsearch_ivf_scan_k1a_bf16": [_P] * 10 + [_I] * 7 + _K1_TAIL,
    "annsearch_ivf_scan_bf16_decode": [_P] * 10 + [_I] * 10 + _K1_TAIL,
    "annsearch_ivf_scan_k1b_cos": [_P] * 10 + [_I] * 8 + _K1_TAIL,
    "annsearch_ivf_scan_i8dec": [_P] * 9 + [_I] * 9 + _K1_TAIL,
    "annsearch_ivf_scan_f32": [_P] * 8 + [_I] * 8 + _K1_TAIL,
    "annsearch_ivf_scan_bf16": [_P] * 8 + [_I] * 8 + _K1_TAIL,
    "annsearch_ivf_scan_sq8": [_P] * 8 + [_I] * 8 + _K1_TAIL,
    "annsearch_ivf_scan_last_launch": [_P],
    "annsearch_ivf_scan_plan": [_I] * 6 + [_P],
    "annsearch_flat_scan": [_P] * 10 + [_I] * 8 + [_P],
    "annsearch_flat_scan_plan": [_I, _I, _P],
    "annsearch_flat_extract": [_P] * 5 + [_I] * 3 + [_P],
    "annsearch_mma_probe": [_P] * 4 + [_I, _P],
    "annsearch_wgmma_probe": [_P] * 4 + [_I, _P],
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
    for p in _sources() + sorted(SOURCE_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def build_log() -> str:
    """The compiler's output of the current build (ptxas register and
    shared-memory usage), or "" before the first build."""
    log = _build_dir() / "build.log"
    return log.read_text() if log.exists() else ""


def _short_name(mangled: str) -> str:
    """A kernel's name with its template arguments as the compiler mangles
    them (``flat_scan_kernelILi2ELi3ELb1EE`` is ``<2, 3, true>``)."""
    m = re.search(r"((?:ivf|flat)_[a-z_]+kernel)(?:(I\w+?E)Ev)?", mangled)
    return m.group(1) + (m.group(2) or "") if m else mangled


def kernel_resources() -> list[tuple[str, str]]:
    """``(kernel, resources)`` per compiled kernel instance of the current
    build, from ``ptxas -v``: the kernel's name with its template arguments
    as the compiler mangles them (``flat_scan_kernelILi2ELb0ELb1EE`` is
    ``<2, false, true>``), and ptxas's registers, static shared memory,
    barriers and spills. Dynamic shared memory is set at launch and is not
    in the compiler's output."""
    out, name, spills = [], None, ""
    for line in build_log().splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = _short_name(line.split("'")[1])
        elif "spill" in line:
            spills = line
        elif line.startswith("ptxas info") and "Used" in line and name:
            out.append((name, line.split(":", 1)[1].strip() + "; " + spills))
            name = None
    return out


def mma_counts() -> tuple[str, dict[str, tuple[int, int, int, int]]]:
    """Tensor-core and TMA instructions of each kernel of the built library:
    ``("sass", {kernel: (HMMA, IMMA, HGMMA or IGMMA, UTMALDG)})`` counted in
    ``cuobjdump -sass`` where the toolkit has it, else ``("ptx", {kernel:
    (mma.sync with bf16 operands, with s8 operands, wgmma.mma_async,
    cp.async.bulk.tensor)})`` counted in the PTX that ``nvcc -ptx`` makes of
    each source."""
    load_library()
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    counts: dict[str, list[int]] = {}
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", str(_build_dir() / _LIB_NAME)],
                              capture_output=True, text=True, check=True).stdout
        head, marks, kind = r"Function : (\S+)", ("HMMA", "IMMA", "GMMA", "UTMALDG"), "sass"
    else:
        text = ""
        for p in _sources():
            ptx = _build_dir() / f"{p.stem}.ptx"
            subprocess.run([_nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx", "-o",
                            str(ptx), str(p)], capture_output=True, check=True)
            text += ptx.read_text()
        head, kind = r"\.entry (\S+?)\(", "ptx"
        marks = ("mma.sync.aligned.m16n8k16", "s8.s8.s32", "wgmma.mma_async",
                 "cp.async.bulk.tensor")
    name = None
    for line in text.splitlines():
        m = re.search(head, line)
        if m:
            name = _short_name(m.group(1))
            counts.setdefault(name, [0] * len(marks))
        elif name is not None:
            for i, mark in enumerate(marks):
                counts[name][i] += mark in line
    return kind, {k: tuple(v) for k, v in counts.items()}


def mma_sync_once(a, b, c):
    """One ``mma.sync.m16n8k16`` bf16 → f32 of the scans (``csrc/mma_probe.cu``)
    per problem: ``a [P, 16, 16]`` and ``b [P, 16, 8]`` bf16, ``c [P, 16, 8]``
    f32, CUDA tensors; returns ``a @ b + c`` as the tensor cores sum it."""
    import torch

    a, bt, c = a.contiguous(), b.transpose(1, 2).contiguous(), c.contiguous()
    d = torch.empty_like(c)
    err = load_library().annsearch_mma_probe(
        a.data_ptr(), bt.data_ptr(), c.data_ptr(), d.data_ptr(), a.shape[0],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"mma probe launch failed: cudaError {err}")
    return d


def wgmma_once(a, b, c):
    """One ``wgmma.mma_async.m64n64k16`` bf16 → f32 as K2's scan issues it
    (``csrc/mma_probe.cu``) per problem: ``a [P, 64, 16]`` and ``b [P, 16,
    64]`` bf16, ``c [P, 64, 64]`` f32, CUDA tensors; returns ``a @ b + c``
    as the tensor cores sum it."""
    import torch

    a, bt, c = a.contiguous(), b.transpose(1, 2).contiguous(), c.contiguous()
    d = torch.empty_like(c)
    err = load_library().annsearch_wgmma_probe(
        a.data_ptr(), bt.data_ptr(), c.data_ptr(), d.data_ptr(), a.shape[0],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"wgmma probe launch failed: cudaError {err}")
    return d


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = _build_dir()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{p.stem}.{tag}.o" for p in _sources()]
        # each compiler writes to its own file: no pipe to fill while the
        # others are waited for
        logs = [o.with_suffix(".log") for o in objs]
        procs = []
        for p, o, lg in zip(_sources(), objs, logs):
            with open(lg, "w") as out:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                    stdout=out, stderr=subprocess.STDOUT,
                ))
        failed = any([proc.wait() for proc in procs])
        log = "".join(lg.read_text() for lg in logs)
        tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            log += link.stdout + link.stderr
            failed = link.returncode != 0
        (out_dir / "build.log").write_text(log)
        for f in objs + logs:
            f.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
