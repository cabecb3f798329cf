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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
# source -> its own flags. The stage-2 kernels reproduce the JAX package's
# f32 op sequence bit for bit, so nvcc must not contract a multiply and an
# add into an FMA there; the conv kernels (K9-K11) and the cost volume (K8)
# are held to a tolerance and keep nvcc's default contraction, as do K12
# (its transforms and collapses, held bit for bit to the twin, use the
# __fmul_rn/__fadd_rn intrinsics, which nvcc never contracts), the copies
# (K7, K15, K16) and the integer probes (K13, K14).
_SOURCES = {
    "compact_rows.cu": ("-fmad=false",),
    "merge_rows.cu": ("-fmad=false",),
    "gen_compact.cu": ("-fmad=false",),
    "gen_pack.cu": ("-fmad=false",),
    "conv3d.cu": (),
    "decoder_conv.cu": (),
    "correlation.cu": (),
    "conv3d_quad.cu": (),
    "wino4.cu": (),
    "stream_copy.cu": (),
    "roofline.cu": (),
}
_HEADERS = ("common.cuh", "conv_igemm.cuh")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# entry point -> argtypes (the trailing pointer is the CUDA stream)
_SIGNATURES = {
    "v2ce_compact_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "v2ce_compact_rows_window": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "v2ce_merge_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "v2ce_gen_compact": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "v2ce_gen_pack": [_P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "v2ce_append_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "v2ce_conv3d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "v2ce_decoder_conv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "v2ce_correlation": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "v2ce_conv3d_quad": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "v2ce_conv3d_wino4": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    "v2ce_layout_barrier": [_P, _P, _L, _L, _P],
    "v2ce_stream_copy": [_P, _P, _L, _L, _L, _P],
    "v2ce_stream_copy_row": [_P, _P, _L, _L, _P],
    "v2ce_op_chain": [_P, _P, _I, _I, _I, _I, _P],
    "v2ce_op_chain_ilp": [_P, _P, _I, _I, _I, _I, _P],
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
    for name, flags in _SOURCES.items():
        h.update(" ".join((name,) + flags).encode())
    for name in (*_SOURCES, *_HEADERS):
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return os.path.join(_build_dir(), f"libv2ce_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. One nvcc per source, all started together, then one
    link. Everything is written under a temporary directory first, so a
    concurrent or interrupted build never leaves a half-written library
    behind."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(path))
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    try:
        for s, flags in _SOURCES.items():
            obj = os.path.join(tmp, s[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, os.path.join(_CSRC, s)]
            procs.append((s, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.PIPE, text=True)))
        for s, _, p in procs:
            err = p.communicate()[1]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{err}")
            if verbose:
                print(f"[nvcc {s}]\n{err}")
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                               *[obj for _, obj, _ in procs]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, path)
    finally:
        for _, _, p in procs:           # after a failure, stop the other builds
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
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

