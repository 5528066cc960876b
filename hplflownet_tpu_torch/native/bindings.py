"""ctypes bindings for the C++ host lattice builder (``lattice_builder.cpp``).

Port of ``hplflownet_tpu/native/bindings.py`` over the port's own copy of
the source.  The library is compiled at first use with ``g++ -O3 -shared
-fPIC`` into ``hplflownet_tpu_torch/_build/liblattice_builder-<hash>.so``;
the hash covers the source, the flags, the machine and the compiler's
version, so an edited source or another host rebuilds it.  A missing
compiler or a failed build raises at once, with the compiler's output
(the JAX binding returns None and fails later).

:class:`HostLatticeBuilder` takes and returns torch CPU tensors.  Keys are
packed into one int64 each, 21 bits per coordinate (the device builder
packs 10 bits into int32 words); the tables are the device builder's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["SOURCE", "COORD_BITS", "SENTINEL", "load_library",
           "pack_keys_i64", "pack_deltas_i64", "HostLatticeBuilder"]

SOURCE = Path(__file__).resolve().parent / "lattice_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

COORD_BITS = 21
COORD_BIAS = 1 << (COORD_BITS - 1)
SENTINEL = (1 << 63) - 1

_LOCK = threading.Lock()
_LIBS: dict = {}
_I64 = ctypes.POINTER(ctypes.c_longlong)
_I32 = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_SIGNATURES = {
    "hpl_build_cloud": (_LL, [_I64, _LL, _LL, _LL, _I64, _I32, _I64]),
    "hpl_neighbor_table": (None, [_I64, _LL, _LL, _LL, _I64, _LL, _I32]),
    "hpl_corr_tables": (None, [_I64, _LL, _LL, _I64, _LL, _LL, _LL,
                               _I64, _LL, _I64, _LL, _I32, _I32]),
}


def _compiler() -> tuple:
    """(g++'s path, its version line); raises when there is no g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the host lattice builder needs g++ on PATH to "
                           f"compile {SOURCE.name}, and there is none")
    out = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60).stdout
    return cxx, out.splitlines()[0] if out else ""


def _lib_path(version: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_FLAGS + (platform.machine(), version)).encode())
    return BUILD_DIR / f"liblattice_builder-{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The loaded library, compiled first if this source, host and compiler
    have not built it yet.  Raises RuntimeError (with g++'s output) when it
    cannot be built."""
    with _LOCK:
        lib = _LIBS.get(SOURCE)
        if lib is not None:
            return lib
        cxx, version = _compiler()
        path = _lib_path(version)
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed to build {SOURCE.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)       # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[SOURCE] = lib
        return lib


def _ptr(t: torch.Tensor, kind):
    return ctypes.cast(t.data_ptr(), kind)


def _host(t, dtype) -> torch.Tensor:
    """``t`` as a contiguous CPU tensor of ``dtype`` (numpy arrays too)."""
    t = torch.as_tensor(t)
    if t.device.type != "cpu":
        raise ValueError(f"the host builder takes CPU tensors, got {t.device}")
    return t.to(dtype).contiguous()


def pack_keys_i64(keys, d: int) -> torch.Tensor:
    """(..., d1) int keys -> (...) int64 packed keys (the redundant last
    coordinate dropped)."""
    keys = _host(keys, torch.int64)
    out = torch.zeros(keys.shape[:-1], dtype=torch.int64)
    for j in range(d):
        out = (out << COORD_BITS) | (keys[..., j] + COORD_BIAS)
    return out


def pack_deltas_i64(offsets, d: int) -> torch.Tensor:
    """(F, d1) stencil offsets -> (F,) int64 deltas of packed keys."""
    offsets = _host(offsets, torch.int64)
    out = torch.zeros(offsets.shape[:-1], dtype=torch.int64)
    for j in range(d):
        out = (out << COORD_BITS) + offsets[..., j]
    return out.contiguous()


class HostLatticeBuilder:
    """The C++ builder over torch CPU tensors (builds the library first)."""

    def __init__(self, d: int = 3):
        self.d = d
        self.lib = load_library()

    def build_cloud(self, keys, capacity: int):
        """keys (N, d1, d1) int -> (unique (capacity,) int64 sorted packed
        keys, sentinel-padded; ids (N, d1) int32 dense ids, -1 past
        capacity; the true number of unique keys)."""
        keys = _host(keys, torch.int64)
        packed = pack_keys_i64(keys, self.d).reshape(-1).contiguous()
        n = packed.numel()
        unique = torch.empty(capacity, dtype=torch.int64)
        ids = torch.empty(n, dtype=torch.int32)
        scratch = torch.empty(n, dtype=torch.int64)
        total = self.lib.hpl_build_cloud(
            _ptr(packed, _I64), n, SENTINEL, capacity, _ptr(unique, _I64),
            _ptr(ids, _I32), _ptr(scratch, _I64))
        return unique, ids.reshape(keys.shape[:-1]), int(total)

    def neighbor_table(self, unique: torch.Tensor, num_valid: int,
                       offsets) -> torch.Tensor:
        """(F, capacity) int32 ids of each vertex's stencil neighbours."""
        unique = _host(unique, torch.int64)
        deltas = pack_deltas_i64(offsets, self.d)
        cap, f = unique.numel(), deltas.numel()
        out = torch.empty((f, cap), dtype=torch.int32)
        self.lib.hpl_neighbor_table(_ptr(unique, _I64), cap, num_valid,
                                    SENTINEL, _ptr(deltas, _I64), f,
                                    _ptr(out, _I32))
        return out

    def corr_tables(self, unique1, n1: int, unique2, n2: int,
                    filter_offsets, corr_offsets):
        """-> (pc1 (Cc, cap1) int32: id1 of key1 + corr[c]; pc2 (F, Cc,
        cap1) int32: id2 of key1 + corr[c] + filter[f])."""
        unique1 = _host(unique1, torch.int64)
        unique2 = _host(unique2, torch.int64)
        fd = pack_deltas_i64(filter_offsets, self.d)
        cd = pack_deltas_i64(corr_offsets, self.d)
        cap1 = unique1.numel()
        pc1 = torch.empty((cd.numel(), cap1), dtype=torch.int32)
        pc2 = torch.empty((fd.numel(), cd.numel(), cap1), dtype=torch.int32)
        self.lib.hpl_corr_tables(
            _ptr(unique1, _I64), cap1, n1, _ptr(unique2, _I64),
            unique2.numel(), n2, SENTINEL, _ptr(cd, _I64), cd.numel(),
            _ptr(fd, _I64), fd.numel(), _ptr(pc1, _I32), _ptr(pc2, _I32))
        return pc1, pc2
