"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc into one shared library with a plain C
interface, at first use, into `csrc/build/` (or `$V2CE_KERNEL_BUILD_DIR`),
under a name that hashes the sources and flags, so an edited source is
rebuilt. The library is loaded with ctypes: pointers and the stream pass
as `c_void_p`, sizes as `c_int`, and every entry point returns
`cudaGetLastError()` after its launches.

Nothing here runs on import: a CPU-only installation imports the package
and never reaches `lib()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = ("compact_rows.cu", "merge_rows.cu", "gen_compact.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes (the trailing pointer is the CUDA stream)
_SIGNATURES = {
    "v2ce_compact_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "v2ce_merge_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "v2ce_gen_compact": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last build, if any


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "v2ce_toolbox_tpu_torch are built at first use and "
                       "need the CUDA toolkit (set $NVCC or put nvcc on PATH)")


def _build_dir() -> str:
    return os.environ.get("V2CE_KERNEL_BUILD_DIR",
                          os.path.join(_CSRC, "build"))


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(_build_dir(), f"libv2ce_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Writes to a temporary name first, so a concurrent or
    interrupted build never leaves a half-written library behind."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *[os.path.join(_CSRC, s) for s in _SOURCES]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr)
    os.replace(tmp, path)
    build_seconds = time.time() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream

