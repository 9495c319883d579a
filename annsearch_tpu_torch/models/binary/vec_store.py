"""Vector stores for exact reranking (port of
``annsearch_tpu.models.binary.vec_store``).

``DeviceVectorStore`` keeps the f32 rows on the index's device and gathers
there. ``MmapVectorStore`` keeps them in a raw little-endian f32 file
(``<path>.vec``, with ``<path>.json`` holding ``n`` and ``dim``) for data
larger than device memory: the candidates' rows are gathered on the host
and copied to the device for the rerank product.

The host gather goes through the repository's native library
(``native/vec_store.cc``: ``mmap`` with random-access advice and a thread
pool of row copies), compiled at first use with ``g++`` into
``annsearch_tpu_torch/_build/vecstore-<hash>/`` from the source as it
stands (the prebuilt ``native/libvecstore.so`` is built for another host
and is never loaded). Where no compiler is found, or the build or the
open fails, the store takes a ``numpy.memmap`` gather instead and warns;
``MmapVectorStore.route`` says which route it took (``"native"`` or
``"memmap"``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import torch

__all__ = ["MmapVectorStore", "DeviceVectorStore", "native_library"]

_REPO = Path(__file__).resolve().parents[3]
_SOURCE = _REPO / "native" / "vec_store.cc"
_BUILD = Path(__file__).resolve().parents[2] / "_build"
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


@functools.lru_cache(maxsize=1)
def native_library() -> ctypes.CDLL:
    """The native gather library, compiled from ``native/vec_store.cc`` at
    first use (cached by a hash of the source and flags). Raises
    ``RuntimeError`` where it cannot be built or loaded."""
    cxx = shutil.which("g++")
    if cxx is None or not _SOURCE.exists():
        raise RuntimeError(f"no g++ or no {_SOURCE}: the native gather is unavailable")
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _SOURCE.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"vecstore-{h}" / "libvecstore.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"libvecstore.{os.getpid()}.so")
        proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE), "-lpthread"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"building {_SOURCE} failed:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent processes each rename a whole file
    lib = ctypes.CDLL(str(out))
    lib.vecstore_open.restype = ctypes.c_void_p
    lib.vecstore_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.vecstore_close.restype = None
    lib.vecstore_close.argtypes = [ctypes.c_void_p]
    lib.vecstore_gather.restype = ctypes.c_int
    lib.vecstore_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
    ]
    return lib


class DeviceVectorStore:
    """f32 rows resident on the device; gathers on the device."""

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors.float().contiguous()
        self.n, self.dim = self.vectors.shape

    def gather(self, ids) -> torch.Tensor:
        """ids ``[nq, kc]`` → ``[nq, kc, dim]`` on the device."""
        return self.vectors[torch.as_tensor(ids, device=self.vectors.device).long()]

    def memory_usage_bytes(self) -> int:
        return self.vectors.numel() * 4


class MmapVectorStore:
    """Raw-file store: ``<path>.vec`` (f32 rows) and ``<path>.json``.
    Gathers return tensors on ``device``."""

    def __init__(self, path: str, mmap: np.memmap, n: int, dim: int, device="cuda"):
        self.path = path
        self._mm = mmap
        self.n, self.dim = int(n), int(dim)
        self.device = torch.device(device)
        self._lib = self._handle = None
        self.route = "memmap"
        try:
            lib = native_library()
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"MmapVectorStore: native gather unavailable ({e}); "
                          "gathering through numpy.memmap", RuntimeWarning)
            return
        handle = lib.vecstore_open((path + ".vec").encode(), self.n, self.dim)
        if not handle:
            warnings.warn(f"MmapVectorStore: the native library could not map {path}.vec; "
                          "gathering through numpy.memmap", RuntimeWarning)
            return
        self._lib, self._handle, self.route = lib, handle, "native"

    @classmethod
    def write(cls, path: str, vectors, device="cuda") -> "MmapVectorStore":
        if isinstance(vectors, torch.Tensor):
            vectors = vectors.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
        n, dim = arr.shape
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        arr.tofile(path + ".vec")
        with open(path + ".json", "w") as f:
            json.dump({"n": n, "dim": dim, "dtype": "float32"}, f)
        return cls.open(path, device)

    @classmethod
    def open(cls, path: str, device="cuda") -> "MmapVectorStore":
        with open(path + ".json") as f:
            meta = json.load(f)
        mm = np.memmap(path + ".vec", dtype=np.float32, mode="r",
                       shape=(meta["n"], meta["dim"]))
        return cls(path, mm, meta["n"], meta["dim"], device)

    def gather(self, ids) -> torch.Tensor:
        """ids ``[nq, kc]`` → ``[nq, kc, dim]`` on the store's device (rows
        gathered on the host). Out-of-range ids give zero rows on the native
        route, as the JAX package's native gather gives them."""
        ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        flat = np.ascontiguousarray(ids.reshape(-1), np.int64)
        if self._handle is not None:
            out = np.empty((flat.size, self.dim), np.float32)
            rc = self._lib.vecstore_gather(self._handle, flat.ctypes.data, flat.size,
                                           out.ctypes.data, 0)
            if rc != 0:
                raise RuntimeError(f"native gather from {self.path}.vec failed ({rc})")
        else:
            out = np.asarray(self._mm[flat])
        return torch.from_numpy(out.reshape(ids.shape + (self.dim,))).to(self.device)

    def close(self) -> None:
        """Release the native mapping (the store then gathers by memmap)."""
        if self._handle is not None:
            self._lib.vecstore_close(self._handle)
            self._handle, self.route = None, "memmap"

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()

    def memory_usage_bytes(self) -> int:
        # on disk, not in host or device memory
        return 0

    def file_size_bytes(self) -> int:
        """Bytes of the ``.vec`` file on disk."""
        return os.path.getsize(self.path + ".vec")
