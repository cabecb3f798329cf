"""ctypes binding of the native event-IO library's voxel splat
(native/event_io.cpp `v2ce_voxel_splat`), the data pipeline's hot loop.

From `v2ce_toolbox_tpu/io/native.py`, with its own build location: the
library is compiled on demand with g++ into the port's build directory
(`csrc/build/`, or `$V2CE_KERNEL_BUILD_DIR`) under a name that hashes the
source, and the caller falls back to numpy when there is no toolchain.
The library's stream packer and sort check are not bound: the port
decodes its event streams in `pipeline/driver.py`.
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

