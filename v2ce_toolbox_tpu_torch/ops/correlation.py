"""K8: the correlation cost volume of FastFlowNet.

Counterpart of `v2ce_toolbox_tpu/ops/correlation.py:correlation`, in the
port's NCHW layout: f1, f2 (N, C, H, W) f32 -> (N, (2md+1)^2, H, W) f32,

    out[n, (dy+md)*(2md+1) + (dx+md), y, x]
        = (sum_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx]) * (1/C)

with f2 zero outside its plane: the TPU kernel's `sum * inv_c`. With
`taps`, only those planes, in that order (`correlation(...)[:, taps]`
bit for bit on the card: each sum is the same fmaf chain over c
ascending); with `out`, written into that (N, T, H, W) view, whose batch
stride may exceed T*H*W (FastFlowNet's decoder input). On a CPU tensor
it runs the plain twin; on a CUDA tensor it launches
`csrc/correlation.cu` with the tiling of `plan`, or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda

launches = {"correlation": 0}

MAX_DISPLACEMENTS = (1, 2, 3, 4)     # the kernel's compiled variants
# the kernel's limits (csrc/correlation.cu): threads a block, ring stages,
# shared memory a block may use on an H100
MAX_THREADS = 288
MAX_STAGES = 4
MAX_SMEM = 232448
MIN_ITEMS = 96                       # work items (tile, image, dy rows) a TMA level should give
STAGE_BYTES = 48 * 1024              # a ring stage's budget
RING_BYTES = 96 * 1024               # the ring's, so that two blocks share an SM
# f32 sums a thread keeps, (2md+1) x P: 36 at md 4 and P 4, the most any
# plan asks for (the launch bound of two 288-thread blocks an SM leaves a
# thread 96 registers; ptxas spills none at md 4)
MAX_SUMS = 36
PLAN_FIELDS = ("tx", "ty", "p", "dyb", "cs", "stages", "r1", "r2")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _pitch(n: int) -> int:
    """The least row pitch >= n floats that is 4 mod 8: a quarter warp's
    16-byte loads of two neighbouring rows then fall on distinct banks."""
    return n + (4 - n % 8) % 8


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(n: int, c: int, h: int, w: int, md: int) -> dict:
    """The kernel's tiling of one (N, C, H, W) cost volume at max
    displacement md, computed from the shapes alone:

      p       x pixels a thread: 4, or 2 below 256 pixels a plane, so the
              coarse levels get more threads;
      tx, ty  the tile: tx a multiple of p up to 32 wasting the fewest
              columns, ty rows of about one warp of p-pixel groups wasting
              at most an eighth of H (all of H where it fits);
      dyb     dy rows a work item (a divisor of 2md+1): with TMA the most
              that keeps MIN_ITEMS items (tile, image, dy rows), else the
              most that fits MAX_THREADS;
      cs      channels a slice: a power of two within STAGE_BYTES with TMA,
              within RING_BYTES without;
      stages  ring stages within RING_BYTES (1 without TMA, where W is not a
              multiple of 4);
      r1, r2  the f1 and f2 tiles' row pitches in floats.

    Also the threads a block, the work items, the shared memory a block
    takes (`smem_bytes`, as `csrc/correlation.cu` computes it) and the f32
    sums a thread keeps (`sums`). The kernel runs as many blocks as the card
    holds at once, each walking items."""
    d = 2 * md + 1
    tma = w % 4 == 0
    p = 4 if h * w >= 256 else 2
    vw = 4 if p % 4 == 0 else 2
    window = _ceil(p + 2 * md, vw) * vw
    widths = [t for t in (32, 16, 8, 4, 2) if t % p == 0]
    if _ceil(w, p) * p <= 32:
        widths.append(_ceil(w, p) * p)
    tx = min(widths, key=lambda t: (_ceil(w, t) * t, -t))
    gpr = tx // p
    cap = max(1, 32 // gpr)
    if h <= cap:
        ty = h
    else:
        rows = [cap] + [1 << k for k in range(5, -1, -1) if (1 << k) < cap]
        ty = next(t for t in rows if _ceil(h, t) * t - h <= h / 8)
    g = gpr * ty
    tiles = n * _ceil(w, tx) * _ceil(h, ty)
    fitting = [v for v in range(d, 0, -1) if d % v == 0 and g * v <= MAX_THREADS]
    dyb = (next((v for v in fitting if tiles * (d // v) >= MIN_ITEMS), fitting[-1]) if tma
           else fitting[0])
    by2 = ty + dyb - 1
    r1, r2 = _pitch(tx), _pitch(tx - p + window)
    per_channel = 4 * (by2 * r2 + ty * r1)
    budget = STAGE_BYTES if tma else RING_BYTES
    cs = min(c, 256, 1 << max(0, (budget // per_channel).bit_length() - 1))
    stage = 4 * (_ceil(cs * by2 * r2, 32) * 32 + _ceil(cs * ty * r1, 32) * 32)
    stages = max(1, min(MAX_STAGES, _ceil(c, cs), RING_BYTES // stage)) if tma else 1
    return dict(tx=tx, ty=ty, p=p, dyb=dyb, cs=cs, stages=stages, r1=r1, r2=r2, tma=tma,
                threads=g * dyb, items=tiles * (d // dyb), smem_bytes=128 + stages * stage,
                sums=d * p)


@functools.lru_cache(maxsize=64)
def _plan_ints(n: int, c: int, h: int, w: int, md: int):
    """`plan` as the C entry takes it (a cached ctypes int array)."""
    pl = plan(n, c, h, w, md)
    return (ctypes.c_int * len(PLAN_FIELDS))(*(pl[k] for k in PLAN_FIELDS))


@functools.lru_cache(maxsize=64)
def _tap_list(taps: Optional[tuple], md: int):
    """(the taps as a list, as a cached ctypes int array or None for all),
    checked once for each list."""
    d2 = (2 * md + 1) ** 2
    if taps is None:
        return list(range(d2)), None
    if len(set(taps)) != len(taps) or not all(0 <= t < d2 for t in taps):
        raise ValueError(f"correlation: taps must be distinct taps in [0, {d2}), got {taps}")
    return list(taps), (ctypes.c_int * len(taps))(*taps)


def _correlation_torch(f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """Plain twin of `correlation` (any device), all taps."""
    md = max_displacement
    _, c, h, w = f1.shape
    f2p = F.pad(f2, (md, md, md, md))
    taps = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(1)
            for dy in range(2 * md + 1) for dx in range(2 * md + 1)]
    return torch.stack(taps, 1) * (1.0 / c)


def _check_out(out: torch.Tensor, like: torch.Tensor, t: int) -> None:
    n, _, h, w = like.shape
    if (out.dtype != torch.float32 or out.device != like.device
            or tuple(out.shape) != (n, t, h, w) or out.stride()[1:] != (h * w, w, 1)
            or (n > 1 and out.stride(0) < t * h * w)):
        raise ValueError(f"correlation: out must be a float32 ({n}, {t}, {h}, {w}) view on "
                         f"{like.device} with strides (>= {t * h * w}, {h * w}, {w}, 1), got "
                         f"{out.dtype} {tuple(out.shape)} strides {out.stride()} on "
                         f"{out.device}")


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                taps: Optional[Sequence[int]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cost volume (K8).

    Args:
      f1, f2: (N, C, H, W) float32 feature maps of one device.
      max_displacement: md, 1 to 4 on the card; (2md+1)^2 taps.
      taps: distinct taps (host integers in [0, (2md+1)^2)) to keep, in
        this order; None keeps all.
      out: an (N, T, H, W) float32 view to write into (plane, row and pixel
        strides H*W, W, 1; any batch stride >= T*H*W), T the number of taps.
    Returns:
      (N, T, H, W) float32: `out` where given.
    """
    md = max_displacement
    if taps is not None and not isinstance(taps, tuple):
        taps = tuple(int(t) for t in taps)
    tap_list, tap_arr = _tap_list(taps, md)
    if out is not None:
        _check_out(out, f1, len(tap_list))
    if f1.device.type == "cpu":
        res = _correlation_torch(f1, f2, md)
        if taps is not None:
            res = res[:, tap_list]
        return res if out is None else out.copy_(res)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation: expected CUDA tensors, got {f1.device} and {f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise ValueError(f"correlation: expected float32, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: expected two (N, C, H, W) maps of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if md not in MAX_DISPLACEMENTS:
        raise ValueError(f"correlation: max_displacement must be one of {MAX_DISPLACEMENTS}, "
                         f"got {md}")
    n, c, h, w = f1.shape
    a, b = f1.contiguous(), f2.contiguous()
    if out is None:
        out = torch.empty((n, len(tap_list), h, w), dtype=torch.float32, device=f1.device)
    plan_arr = _plan_ints(n, c, h, w, md)
    with torch.cuda.device(f1.device):
        err = _cuda.lib().v2ce_correlation(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, c, h, w, md, 1.0 / c,
            None if tap_arr is None else ctypes.addressof(tap_arr), len(tap_list),
            out.stride(0) if n > 1 else len(tap_list) * h * w, ctypes.addressof(plan_arr),
            _cuda.stream_of(f1))
    _cuda.check(err, "correlation")
    launches["correlation"] += 1
    return out
