"""ctypes bindings of the native event-IO library (native/event_io.cpp):
the voxel splat `v2ce_voxel_splat` (the data pipeline's hot loop), the
stream packer `v2ce_pack_event_stream` (per-frame SoA buffers -> one
stream of the 13-byte EVENT_DTYPE records, in one multithreaded pass) and
the sort check `v2ce_first_inversion`.

From `v2ce_toolbox_tpu/io/native.py`, with its own build location: the
library is compiled on demand with g++ into the port's build directory
(`csrc/build/`, or `$V2CE_KERNEL_BUILD_DIR`) under a name that hashes the
source, and every entry falls back to numpy when there is no toolchain.
The port's CLI decodes its event streams in `pipeline/driver.py`; the
packer is for callers holding per-frame host buffers.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import os.path as op
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE

logger = logging.getLogger(__name__)

_REPO = op.dirname(op.dirname(op.dirname(op.abspath(__file__))))
_SRC = op.join(_REPO, "native", "event_io.cpp")
_GXX = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _library_path() -> str:
    from v2ce_toolbox_tpu_torch.ops._cuda import _build_dir

    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(" ".join(_GXX).encode() + fh.read()).hexdigest()[:16]
    return op.join(_build_dir(), f"libv2ce_event_io_{digest}.so")


def _build(so_path: str) -> None:
    """g++ into a temporary directory beside the library, then an atomic
    rename, so concurrent builds never load a half-written file."""
    os.makedirs(op.dirname(so_path), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=op.dirname(so_path))
    try:
        out = op.join(tmp, "lib.so")
        subprocess.run(["g++", *_GXX, "-o", out, _SRC, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(out, so_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so_path = _library_path()
        if not op.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        lib.v2ce_pack_event_stream.restype = ctypes.c_int64
        lib.v2ce_pack_event_stream.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.v2ce_first_inversion.restype = ctypes.c_int64
        lib.v2ce_first_inversion.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.v2ce_voxel_splat.restype = None
        lib.v2ce_voxel_splat.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:  # no g++, or it failed
        logger.warning("native event IO unavailable (%s); numpy fallback", e)
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def voxel_splat(events: np.ndarray, vol: np.ndarray) -> bool:
    """Native discretized-volume splat into a zeroed (2*nb, H, W) float32
    `vol` from structured events; returns False when the library is
    unavailable (caller falls back to np.add.at). Bit-identical to the
    numpy recipe in data/voxelize.gen_discretized_event_volume_np."""
    lib = _load()
    if lib is None or vol.dtype != np.float32 or not vol.flags.c_contiguous:
        return False
    t = np.ascontiguousarray(events["timestamp"], np.int64)
    x = np.ascontiguousarray(events["x"], np.int16)
    y = np.ascontiguousarray(events["y"], np.int16)
    p = np.ascontiguousarray(events["polarity"], np.int8)
    nb2, h, w = vol.shape
    lib.v2ce_voxel_splat(
        t.ctypes.data, x.ctypes.data, y.ctypes.data, p.ctypes.data,
        len(events), nb2 // 2, h, w,
        vol.ctypes.data_as(ctypes.c_void_p))
    return True



def pack_event_stream(t_us: np.ndarray, x: np.ndarray, y: np.ndarray, p: np.ndarray,
                      counts: np.ndarray, frame_offsets_us: np.ndarray,
                      num_threads: int = 4) -> np.ndarray:
    """Per-frame (B, E) SoA buffers (int32 t, int16 x / y, int8 p), their
    (B,) int32 counts and (B,) int64 frame offsets -> one concatenated
    EVENT_DTYPE stream, t + offset in int64."""
    b, _ = t_us.shape
    total = int(counts.sum())
    out = np.empty(total, dtype=EVENT_DTYPE)
    lib = _load()
    if lib is not None and total:
        t_us = np.ascontiguousarray(t_us, np.int32)
        x = np.ascontiguousarray(x, np.int16)
        y = np.ascontiguousarray(y, np.int16)
        p = np.ascontiguousarray(p, np.int8)
        counts = np.ascontiguousarray(counts, np.int32)
        offs = np.ascontiguousarray(frame_offsets_us, np.int64)
        n = lib.v2ce_pack_event_stream(
            t_us.ctypes.data, x.ctypes.data, y.ctypes.data, p.ctypes.data,
            counts.ctypes.data, offs.ctypes.data, b, t_us.shape[1],
            out.ctypes.data_as(ctypes.c_void_p), num_threads)
        if n != total:
            raise RuntimeError(f"v2ce_pack_event_stream wrote {n} events of {total}")
        return out
    return _pack_event_stream_np(t_us, x, y, p, counts, frame_offsets_us, out)


def _pack_event_stream_np(t_us, x, y, p, counts, frame_offsets_us, out):
    pos = 0
    for f in range(t_us.shape[0]):
        n = int(counts[f])
        out["timestamp"][pos:pos + n] = t_us[f, :n].astype(np.int64) + int(frame_offsets_us[f])
        out["x"][pos:pos + n] = x[f, :n]
        out["y"][pos:pos + n] = y[f, :n]
        out["polarity"][pos:pos + n] = p[f, :n]
        pos += n
    return out


def first_inversion(stream: np.ndarray) -> int:
    """Index of the first timestamp inversion in an EVENT_DTYPE stream, -1
    if it is sorted."""
    lib = _load()
    if lib is not None:
        s = np.ascontiguousarray(stream)
        return int(lib.v2ce_first_inversion(s.ctypes.data_as(ctypes.c_void_p), len(s)))
    bad = np.nonzero(np.diff(stream["timestamp"]) < 0)[0]
    return int(bad[0] + 1) if len(bad) else -1
