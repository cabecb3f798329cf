"""LDATI candidate generation fused with the chain compaction (K1).

Counterpart of `v2ce_toolbox_tpu/ops/gen_pallas.py:gen_compact` for the
'slope' strategy. On a CPU tensor `gen_compact` runs its plain twin (the
ports of `ldati.relocate_counts`, `ldati.slope_params` and the candidate
packing of `_sample_events_v3`, then the plain compaction); on a CUDA
tensor it launches `csrc/gen_compact.cu`, or raises.

Rows come out in the canonical order of `compact_rows(gen_pack(...))`:
ascending within-bin voxel id. The TPU kernel's (polarity, w-block, h,
w % 128) order is a tiling artifact; it equals the canonical order for
W <= 128 and whenever no capacity binds.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.compact import (
    INVALID,
    _round_up,
    compact_rows_torch,
)
from v2ce_toolbox_tpu_torch.ops.ldati import f32, fma32, relocate_counts, slope_k

launches = {"gen_compact": 0}

GenOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    launches["gen_compact"] = 0


def bin_constants(cb: int, fps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bin start in seconds (f32) and in whole µs (int32), computed in
    numpy f32 exactly as gen_pallas.py does (t0 = 0)."""
    voxel_step = 1.0 / fps / cb
    bs = np.arange(cb, dtype=np.float32) * np.float32(voxel_step)
    return bs, (bs * np.float32(1e6)).astype(np.int32)


def tend_scale(cb: int, fps: int) -> np.float32:
    """The chain timestamp `tend / fps / cb + bin_start` as XLA evaluates
    it: the two constant divisions fold into one multiply by
    f32(1/fps) * f32(1/cb), and the multiply-add is one FMA."""
    return np.float32(np.float32(1.0 / fps) * np.float32(1.0 / cb))


def gen_pack_torch(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uncompacted candidate rows (B*(C-1), P*H*W): keys and kx payload,
    plus per-frame emit and over-mepv drop sums (any device)."""
    bb, p, c, h, w = voxels.shape
    cb = c - 1
    seg = p * h * w
    dev = voxels.device
    # pre-ordered layout (B, C, P_flipped*H, W): OFF before ON in a bin
    y = torch.flip(voxels.float(), [1]).transpose(1, 2).reshape(bb, c, p * h, w)
    counts, tend = relocate_counts(y)                   # (B, cb, P*H, W)
    bs_np, bs_us_np = bin_constants(cb, fps)
    bs = torch.from_numpy(bs_np).to(dev).view(1, cb, 1, 1)
    bs_us = torch.from_numpy(bs_us_np).to(dev).view(1, cb, 1, 1)

    is_chain = counts == 1
    emit = torch.where(is_chain, 1, torch.clamp(counts, max=mepv)).clamp(min=0)
    ts_us = (fma32(tend, tend_scale(cb, fps), bs) * f32(1e6, dev)).to(torch.int32)
    ts_cap = (1 << (31 - vox_bits)) - 2
    rel = torch.where(is_chain, torch.clamp(ts_us - bs_us, 0, ts_cap), 0)
    vox = torch.arange(seg, dtype=torch.int32, device=dev).view(1, 1, p * h, w)
    keys = torch.where(emit > 0, (rel << vox_bits) | vox, INVALID).to(torch.int32)

    k = slope_k(counts, fps)
    extra = torch.clamp(counts - 1, min=0).clamp(max=min(mepv - 1, 255))
    kx = (k.view(torch.int32) & ~0xFF) | extra
    drop = torch.where(counts > mepv, counts - mepv, 0)
    return (keys.reshape(bb * cb, seg), kx.reshape(bb * cb, seg),
            emit.sum(dim=(1, 2, 3), dtype=torch.int32),
            drop.sum(dim=(1, 2, 3), dtype=torch.int32))


def gen_compact_torch(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
                      cap_bin: int, chunk: int = 16384) -> GenOut:
    """Plain twin of `gen_compact` (any device)."""
    keys, kx, emit, drop = gen_pack_torch(voxels, fps=fps, mepv=mepv,
                                          vox_bits=vox_bits)
    rk, (rkx,), kept, total = compact_rows_torch(keys, [kx], cap=cap_bin, chunk=chunk)
    return rk, rkx, kept, total, emit, drop


def gen_compact(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
                cap_bin: int, chunk: int = 16384) -> GenOut:
    """Relocate + slope + candidate packing + chain compaction, 'slope'.

    Args:
      voxels: (B, P, 10, H, W) float32 voxel grid (P index 0 = ON).
      vox_bits: bit width of the within-bin voxel id in the packed key.
      cap_bin: candidates kept per (frame, bin) row, rounded up to `chunk`.
    Returns:
      keys (B*9, cap') int32 (INVALID past kept), kx (B*9, cap') int32
      slope payload (0 past kept), kept (B*9,), total (B*9,), emit (B,),
      drop (B,) — the outputs of gen_pallas.gen_compact.
    """
    if voxels.device.type == "cpu":
        return gen_compact_torch(voxels, fps=fps, mepv=mepv, vox_bits=vox_bits,
                                 cap_bin=cap_bin, chunk=chunk)
    if voxels.device.type != "cuda":
        raise ValueError(f"gen_compact: expected a CUDA tensor, got {voxels.device}")
    if (voxels.dim() != 5 or voxels.dtype != torch.float32
            or not voxels.is_contiguous() or voxels.shape[2] != 10):
        raise ValueError("gen_compact: expected a contiguous float32 (B, P, 10, H, W) "
                         f"tensor, got {voxels.dtype} {tuple(voxels.shape)}")
    bb, p, c, h, w = voxels.shape
    cb = c - 1
    if p * h * w >= 1 << 31 or bb * cb > 65535:
        raise ValueError(f"gen_compact: grid {tuple(voxels.shape)} too large")
    capp = _round_up(cap_bin, chunk)
    n_tiles = -(-(p * h * w) // 256)
    dev = voxels.device
    i32 = dict(dtype=torch.int32, device=dev)
    keys = torch.empty((bb * cb, capp), **i32)
    kx = torch.empty_like(keys)
    kept = torch.empty((bb * cb,), **i32)
    total = torch.empty_like(kept)
    emit = torch.empty((bb,), **i32)
    drop = torch.empty_like(emit)
    tile_counts = torch.empty((bb * cb * n_tiles,), **i32)
    tile_off = torch.empty_like(tile_counts)
    tile_emit = torch.empty((bb * n_tiles,), **i32)
    tile_drop = torch.empty_like(tile_emit)
    bs_np, bs_us_np = bin_constants(cb, fps)
    bs_c = (ctypes.c_float * cb)(*bs_np.tolist())
    bs_us_c = (ctypes.c_int * cb)(*bs_us_np.tolist())
    voxel_step = 1.0 / fps / cb
    with torch.cuda.device(dev):
        err = _cuda.lib().v2ce_gen_compact(
            voxels.data_ptr(), ctypes.cast(bs_c, ctypes.c_void_p),
            ctypes.cast(bs_us_c, ctypes.c_void_p),
            keys.data_ptr(), kx.data_ptr(), kept.data_ptr(), total.data_ptr(),
            emit.data_ptr(), drop.data_ptr(), tile_counts.data_ptr(),
            tile_off.data_ptr(), tile_emit.data_ptr(), tile_drop.data_ptr(),
            bb, p, h, w, vox_bits, (1 << (31 - vox_bits)) - 2, mepv, capp,
            float(tend_scale(cb, fps)), float(np.float32(voxel_step ** 2)),
            _cuda.stream_of(voxels))
    _cuda.check(err, "gen_compact")
    launches["gen_compact"] += 1
    return keys, kx, kept, total, emit, drop
