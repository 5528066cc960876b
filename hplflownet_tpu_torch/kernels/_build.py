"""Build the CUDA sources with ``nvcc`` and load them through ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``_build/lib<name>-<hash>.so`` for ``sm_90a`` (Hopper).  The hash
covers the source and the flags, so an edited source is rebuilt and an
unchanged one is reused (the hash also covers the shared headers,
``csrc/*.cuh``).  No PyTorch headers are compiled: a build takes
seconds, not the minutes of ``torch.utils.cpp_extension``.

Every pointer and the CUDA stream cross the boundary as ``ctypes.c_void_p``
(a bare Python int would be cut to 32 bits).  Each C entry point launches
on the caller's stream and returns ``cudaGetLastError()``.  :func:`entry`
sets an entry point's argument and return types once per loaded library,
so a wrapper's call costs one ctypes call on the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["SOURCES", "find_nvcc", "build", "load", "entry", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("stencil_gather_matmul", "rank_reduce", "stencil_dkernel",
           "stencil_tap_tables_sum", "blocked_rank_reduce", "row_take",
           "rank_partial", "dense_gemm", "slice_points")
_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: dict = {}
_ENTRIES: dict = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, under $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of hplflownet_tpu_torch are "
        "built from hplflownet_tpu_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # included sources
        h.update(header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile the named sources that are not built yet, all in parallel.

    Returns ``{name: (seconds, compiler_output)}`` for the sources compiled
    by this call (``verbose`` adds ``-Xptxas -v``: registers, shared memory
    and spills per kernel).  Raises with the compiler's output on failure.
    """
    flags = _FLAGS + (("-Xptxas=-v",) if verbose else ())
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *flags, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    done, errors = {}, []
    for n, (p, tmp, t0) in procs.items():
        out, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        os.replace(tmp, _lib_path(n))
        done[n] = (secs, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, args: str):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, returning
    an int, with its argument types set from ``args`` (one letter each:
    ``p`` a pointer or the stream, ``i`` an int, ``f`` a float) the first
    time it is asked for."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[a] for a in args]
        _ENTRIES[name, symbol] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA error
    code."""
    if rc != 0:
        fn = load(name).hpl_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
