"""LDATI candidate generation: K1 (fused with the chain compaction) and K4.

Counterparts of `v2ce_toolbox_tpu/ops/gen_pallas.py:gen_compact` and
`gen_pack`, for the strategies 'slope' and 'none'. On a CPU tensor each
entry point runs its plain twin (the ports of `ldati.relocate_counts`, the
slope fit and the candidate packing of `_sample_events_v3`, then for K1 the
plain compaction); on a CUDA tensor it launches `csrc/gen_compact.cu` or
`csrc/gen_pack.cu`, or raises.

K1's rows come out in the canonical order of `compact_rows(gen_pack(...))`:
ascending within-bin voxel id. The TPU kernel's (polarity, w-block, h,
w % 128) order is a tiling artifact; it equals the canonical order for
W <= 128 and whenever no capacity binds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.compact import (
    INVALID,
    _round_up,
    compact_rows_torch,
)
from v2ce_toolbox_tpu_torch.ops.ldati import f32, fma32, relocate_counts, slope_k

launches = {"gen_compact": 0, "gen_pack": 0}
TILE_PIXELS = 1024     # pixels per compute tile of csrc/gen_compact.cu
FILL = 4096            # output slots per fill tile
QUANTITIES = 11        # a tile's published numbers: 9 row counts, emit, drop

GenOut = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]
PackOut = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]
STRATEGIES = ("slope", "none")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def bin_constants(cb: int, fps: int, t0: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bin start in seconds (f32) and in whole µs (int32), computed in
    numpy f32 exactly as gen_pallas.py does."""
    voxel_step = 1.0 / fps / cb
    bs = np.arange(cb, dtype=np.float32) * np.float32(voxel_step) + np.float32(t0)
    return bs, (bs * np.float32(1e6)).astype(np.int32)


def tend_scale(cb: int, fps: int) -> np.float32:
    """The chain timestamp `tend / fps / cb + bin_start` as XLA evaluates
    it: the two constant divisions fold into one multiply by
    f32(1/fps) * f32(1/cb), and the multiply-add is one FMA."""
    return np.float32(np.float32(1.0 / fps) * np.float32(1.0 / cb))


def gen_pack_torch(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
                   strategy: str = "slope", t0: float = 0.0) -> PackOut:
    """Plain twin of `gen_pack` (any device)."""
    bb, p, c, h, w = voxels.shape
    cb = c - 1
    seg = p * h * w
    dev = voxels.device
    slope = strategy == "slope"
    # pre-ordered layout (B, C, P_flipped*H, W): OFF before ON in a bin
    y = torch.flip(voxels.float(), [1]).transpose(1, 2).reshape(bb, c, p * h, w)
    counts, tend = relocate_counts(y)                   # (B, cb, P*H, W)
    bs_np, bs_us_np = bin_constants(cb, fps, t0)
    bs = torch.from_numpy(bs_np).to(dev).view(1, cb, 1, 1)
    bs_us = torch.from_numpy(bs_us_np).to(dev).view(1, cb, 1, 1)

    is_chain = counts == 1
    if slope:
        emit = torch.where(is_chain, 1, torch.clamp(counts, max=mepv)).clamp(min=0)
    else:
        emit = is_chain.to(torch.int32)
    ts_us = (fma32(tend, tend_scale(cb, fps), bs) * f32(1e6, dev)).to(torch.int32)
    ts_cap = (1 << (31 - vox_bits)) - 2
    rel = torch.clamp(ts_us - bs_us, 0, ts_cap)
    if slope:
        rel = torch.where(is_chain, rel, 0)
    vox = torch.arange(seg, dtype=torch.int32, device=dev).view(1, 1, p * h, w)
    keys = torch.where(emit > 0, (rel << vox_bits) | vox, INVALID).to(torch.int32)
    emit_sum = emit.sum(dim=(1, 2, 3), dtype=torch.int32)
    if not slope:
        return (keys.reshape(bb * cb, seg), None, emit_sum,
                torch.zeros((bb,), dtype=torch.int32, device=dev))

    k = slope_k(counts, fps)
    extra = torch.clamp(counts - 1, min=0).clamp(max=min(mepv - 1, 255))
    kx = (k.view(torch.int32) & ~0xFF) | extra
    drop = torch.where(counts > mepv, counts - mepv, 0)
    return (keys.reshape(bb * cb, seg), kx.reshape(bb * cb, seg), emit_sum,
            drop.sum(dim=(1, 2, 3), dtype=torch.int32))


def _check_voxels(name: str, voxels: torch.Tensor, strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"{name}: strategy must be one of {STRATEGIES}, got {strategy!r}")
    if voxels.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {voxels.device}")
    if (voxels.dim() != 5 or voxels.dtype != torch.float32
            or not voxels.is_contiguous() or voxels.shape[2] != 10):
        raise ValueError(f"{name}: expected a contiguous float32 (B, P, 10, H, W) "
                         f"tensor, got {voxels.dtype} {tuple(voxels.shape)}")
    bb, p, c, h, w = voxels.shape
    if p * h * w >= 1 << 31 or bb * (c - 1) > 65535:
        raise ValueError(f"{name}: grid {tuple(voxels.shape)} too large")


@functools.lru_cache(maxsize=64)
def _bin_args(cb: int, fps: int, t0: float):
    """The kernels' per-call constants, built once per (cb, fps, t0): the
    bin starts as host arrays (the C entries copy them into the kernel's
    by-value `BinConsts`), the chain timestamp scale and voxel_step^2."""
    bs_np, bs_us_np = bin_constants(cb, fps, t0)
    bs_c = (ctypes.c_float * cb)(*bs_np.tolist())
    bs_us_c = (ctypes.c_int * cb)(*bs_us_np.tolist())
    voxel_step = 1.0 / fps / cb
    return (bs_c, bs_us_c, ctypes.cast(bs_c, ctypes.c_void_p),
            ctypes.cast(bs_us_c, ctypes.c_void_p), float(tend_scale(cb, fps)),
            float(np.float32(voxel_step ** 2)))


def plan(frames: int, seg: int, capp: int) -> Tuple[int, int, int]:
    """K1's launch plan (csrc/gen_compact.cu, which checks it) for `frames`
    frames of seg = P*H*W pixels: (compute tiles a frame, fill tiles a
    (frame, bin) row, 64-bit scratch words). A frame is ceil(seg / 1024)
    compute tiles; a capp-wide row is ceil(capp / 4096) fill tiles, at
    least one (it writes kept and total); the scratch is the ticket and 11
    status words per compute tile."""
    tiles = -(-seg // TILE_PIXELS)
    return tiles, max(1, -(-capp // FILL)), 1 + frames * tiles * QUANTITIES


def gen_pack(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
             strategy: str = "slope", t0: float = 0.0) -> PackOut:
    """Relocate + slope + candidate packing, uncompacted (K4).

    Args:
      voxels: (B, P, 10, H, W) float32 voxel grid (P index 0 = ON).
      vox_bits: bit width of the within-bin voxel id in the packed key.
      strategy: 'slope' or 'none' (chain events only, no payload).
    Returns:
      keys (B*9, P*H*W) int32 (INVALID where a voxel emits nothing), kx of
      the same shape ('slope') or None, emit (B,), drop (B,) — the outputs
      of gen_pallas.gen_pack with the keys as bin rows.
    """
    if voxels.device.type == "cpu":
        return gen_pack_torch(voxels, fps=fps, mepv=mepv, vox_bits=vox_bits,
                              strategy=strategy, t0=t0)
    _check_voxels("gen_pack", voxels, strategy)
    bb, p, c, h, w = voxels.shape
    cb = c - 1
    slope = strategy == "slope"
    i32 = dict(dtype=torch.int32, device=voxels.device)
    keys = torch.empty((bb * cb, p * h * w), **i32)
    kx = torch.empty_like(keys) if slope else None
    emit = torch.empty((bb,), **i32)
    drop = torch.empty_like(emit)
    _, _, bs_p, bs_us_p, tscale, vs2 = _bin_args(cb, fps, t0)
    with torch.cuda.device(voxels.device):
        err = _cuda.lib().v2ce_gen_pack(
            voxels.data_ptr(), bs_p, bs_us_p, keys.data_ptr(),
            kx.data_ptr() if slope else None, emit.data_ptr(), drop.data_ptr(),
            bb, p, h, w, vox_bits, (1 << (31 - vox_bits)) - 2, mepv, int(slope),
            tscale, vs2, _cuda.stream_of(voxels))
    _cuda.check(err, "gen_pack")
    launches["gen_pack"] += 1
    return keys, kx, emit, drop


def gen_compact_torch(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
                      cap_bin: int, chunk: int = 16384, strategy: str = "slope",
                      t0: float = 0.0) -> GenOut:
    """Plain twin of `gen_compact` (any device)."""
    keys, kx, emit, drop = gen_pack_torch(voxels, fps=fps, mepv=mepv,
                                          vox_bits=vox_bits, strategy=strategy, t0=t0)
    rk, pays, kept, total = compact_rows_torch(keys, [kx] if kx is not None else [],
                                               cap=cap_bin, chunk=chunk)
    return rk, (pays[0] if pays else None), kept, total, emit, drop


def gen_compact(voxels: torch.Tensor, *, fps: int, mepv: int, vox_bits: int,
                cap_bin: int, chunk: int = 16384, strategy: str = "slope",
                t0: float = 0.0) -> GenOut:
    """Relocate + slope + candidate packing + chain compaction (K1).

    Args:
      voxels: (B, P, 10, H, W) float32 voxel grid (P index 0 = ON).
      vox_bits: bit width of the within-bin voxel id in the packed key.
      cap_bin: candidates kept per (frame, bin) row, rounded up to `chunk`.
      strategy: 'slope' or 'none' (chain events only, no payload).
    Returns:
      keys (B*9, cap') int32 (INVALID past kept), kx (B*9, cap') int32
      slope payload (0 past kept; None for 'none'), kept (B*9,), total
      (B*9,), emit (B,), drop (B,) — the outputs of gen_pallas.gen_compact.
    """
    if voxels.device.type == "cpu":
        return gen_compact_torch(voxels, fps=fps, mepv=mepv, vox_bits=vox_bits,
                                 cap_bin=cap_bin, chunk=chunk, strategy=strategy, t0=t0)
    _check_voxels("gen_compact", voxels, strategy)
    bb, p, c, h, w = voxels.shape
    cb = c - 1
    slope = strategy == "slope"
    capp = _round_up(cap_bin, chunk)
    tiles, fills, words = plan(bb, p * h * w, capp)
    if (p * h * w >= (1 << 31) - TILE_PIXELS or capp >= (1 << 31) - FILL
            or bb * (tiles + cb * fills) >= 1 << 31):
        raise ValueError(f"gen_compact: grid {tuple(voxels.shape)} -> cap {capp} exceeds "
                         "the kernel's limits")
    dev = voxels.device
    r = bb * cb
    rows = torch.empty((2 if slope else 1, r, capp), dtype=torch.int32, device=dev)  # keys, kx
    # one allocation: the kernel's 64-bit scratch words (zeroed by the C
    # entry), then kept, total, emit and drop
    buf = torch.empty((2 * words + 2 * r + 2 * bb,), dtype=torch.int32, device=dev)
    ptr, rptr = buf.data_ptr(), rows.data_ptr()
    at = 2 * words                     # int32 offsets of kept, total, emit, drop
    _, _, bs_p, bs_us_p, tscale, vs2 = _bin_args(cb, fps, t0)
    with torch.cuda.device(dev):
        err = _cuda.lib().v2ce_gen_compact(
            voxels.data_ptr(), bs_p, bs_us_p, rptr, rptr + 4 * r * capp if slope else None,
            ptr + 4 * at, ptr + 4 * (at + r), ptr + 4 * (at + 2 * r),
            ptr + 4 * (at + 2 * r + bb), ptr,
            bb, p, h, w, vox_bits, (1 << (31 - vox_bits)) - 2, mepv, int(slope), capp,
            tscale, vs2, tiles, fills, words, _cuda.stream_of(voxels))
    _cuda.check(err, "gen_compact")
    launches["gen_compact"] += 1
    return (rows[0], rows[1] if slope else None, buf[at:at + r], buf[at + r:at + 2 * r],
            buf[at + 2 * r:at + 2 * r + bb], buf[at + 2 * r + bb:])
