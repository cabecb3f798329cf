"""LDATI — the stage-2 statistical event sampler.

Port of `v2ce_toolbox_tpu/ops/ldati.py:sample_events` and its v3 core
`_sample_events_v3`, for the strategies 'slope', 'none' and 'random', the
pooling types 'none', 'avg' and 'weighted', and forward or bidirectional
relocation. Candidate generation takes one of three routes, with the JAX
package's gate (`ldati.py:1047-1117`):

  - K1 (`ops/gen.gen_compact`): generation fused with the chain
    compaction, when `use_gen_compact` and the grid is pre-ordered
    (pooling 'none'), forward, 'slope' with mepv > 1 or 'none';
  - else K4 (`ops/gen.gen_pack`) then the chain compaction (K2);
  - else the grid path: relocation, slope fit and candidate packing as
    torch ops, then K2 on the (frame*bin, P*H*W) rows.

Then the v3 core: the deferred slot-0 draw of the non-chain voxels on the
compacted rows, the multi-event pool through K2 ordered by extra count
descending, the tier rows of additional events, the `sort_cap` pre-sort
compaction (K2), one stable sort per (frame, bin) row, and either the
rows (`sample_rows`, for the fused wire path) or the per-frame merge
(K3) into an `EventStream`. 'random' keeps raw U[0, 1) seconds past the
bin start, too wide for the packed key: it runs in two-word form, with
the rel-µs word as the single sort key and the voxel id as payload.

Where the packed key cannot hold the voxel ids (`supports_rows`: e.g.
260x346 at 13 fps or less, or wider than 1008 px at 30 fps), the v2 core
runs instead (`ldati.py:220-570` and the
non-v3 tail of `sample_events`): relocation and slope on the grid, then
per frame one stable sort of every (timestamp, voxel) candidate, slot 0
of every voxel and slots 1 .. mepv-1 of a pool of `max_multi_voxels`
multi-event voxels (`compact_frame_events`), into a buffer of width
event_capacity; `sample_events(use_v3=False)` sends every configuration
there. It launches no kernel; the EventStream route's flatten (K5, K2)
follows it in the pipeline. Its compaction goes through
`compact_dispatch`, whose binned route (`compact_frame_events_binned`:
one packed int32 key a candidate, sorted per bin) a caller may ask for.

Uniform draws come from a provider `draw(j, shape) -> Tensor`: j is the
JAX `fold_in` index (0 for slot 0, j for tier j) and `shape` the JAX
draw's shape, so tests can feed the JAX draws and compare bytes. The v2
core draws per frame: its shapes are (B, n), and row f is frame f's
draw (the JAX package splits the chunk key per frame, then folds in j).
In production `make_draw` seeds a `torch.Generator` from (run seed,
chunk, j), so a repeated dispatch draws the same numbers.

Float contract: every f32 expression follows the JAX op order, and the
multiply-adds that XLA contracts into FMA are single-rounding here too:
the chain timestamp `tend / fps / cb + bin_start`, the intercept
`1/vs - k * (vs/2)` and the inverse-CDF discriminant `(2k) * u + b*b`.
`fma32` computes them with a single rounding on any device. The pooling
sums are nine shifted adds of integer counts (times powers of two for
'weighted'): exact in f32, so their order cannot matter. In the v2 core
with the 'none' strategy XLA:CPU contracts the other product of the
chain timestamp, `bin * voxel_step` (see `_sample_events_v2`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.events import EventStream, to_recarrays
from v2ce_toolbox_tpu_torch.ops.compact import (
    INVALID,
    _round_up,
    compact_rows,
    merge_sorted_rows,
)

Draw = Callable[[int, Tuple[int, ...]], torch.Tensor]

STRATEGIES = ("none", "random", "slope")
POOLINGS = ("none", "avg", "weighted")
CHUNK = 16384                  # K2 chunk of the chain and sort_cap compactions


def f32(x: float, device) -> torch.Tensor:
    """An f32 constant as a 0-dim tensor on `device`. Dividing by a Python
    scalar on CUDA multiplies by its reciprocal; dividing by a tensor on
    the same device is IEEE division, as in JAX."""
    return torch.tensor(np.float32(x), device=device)


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a*b + c) with a single rounding, as a hardware f32 FMA.

    The f32 product is exact in f64; the f64 sum s carries the rounding
    error e of its own addition (TwoSum). Stepping s one f64 ulp towards e
    when e != 0 makes the final f64 -> f32 rounding see the sticky bit, so
    a sum that lands on an f32 midpoint still rounds the right way."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    p = a.double() * b
    c = c.double()
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    towards = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where(e != 0, torch.nextafter(s, towards), s).float()


def _bits(n: int) -> int:
    return max(int(np.ceil(np.log2(n))), 1)


def vox_bits_of(p: int, h: int, w: int) -> int:
    """Bit width of the within-bin voxel id in the packed key."""
    return _bits(max(p * h * w, 2))


# ---------------------------------------------------------------------------
# Relocation and slope (ldati.py:73, :150, :177)
# ---------------------------------------------------------------------------

def relocate_counts(y: torch.Tensor, *, bidirectional: bool = False,
                    erase_beginning: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Debt-carrying relocation: (N, C, H, W) voxels -> int32 counts and f32
    tendency, each (N, C-1, H, W).

    Forward: a ceil over the bins carrying the debt, the final input bin
    folded into the last output bin. Bidirectional: the forward ceil fills
    bins [0, (C-1)//2), a backward floor (clipped at 0) fills (C//2, C-2]
    from the last input bin, and the middle bin C//2 meets both; for C = 10
    bin 4 stays 0, as in the reference. `erase_beginning` zeroes the values
    below 0.001 first."""
    eps = f32(1e-6, y.device)
    n, c, h, w = y.shape
    y = y.float()
    if erase_beginning:
        y = torch.where(y < f32(0.001, y.device), torch.zeros_like(y), y)
    until = (c - 1) // 2 if bidirectional else c - 1
    debt = torch.zeros_like(y[:, 0])
    counts, tend = [], []
    for ci in range(until):
        avail = y[:, ci] - debt
        cf = torch.ceil(avail - eps)
        debt = cf - avail
        counts.append(cf.to(torch.int32))
        tend.append(debt)
    if not bidirectional:
        counts[-1] = counts[-1] + (y[:, -1] - debt).to(torch.int32)
        return torch.stack(counts, 1), torch.stack(tend, 1)

    zero_i = torch.zeros_like(counts[0])
    counts += [zero_i] * (c - 1 - until)
    tend += [torch.zeros_like(debt)] * (c - 1 - until)
    bless = y[:, c - 1]
    for i in range(c - 2, c // 2, -1):
        tend[i] = bless                          # recorded before the update
        yf = torch.floor(y[:, i] + bless + eps)
        bless = torch.clamp(y[:, i] - yf + bless, min=0)
        counts[i] = yf.to(torch.int32)
    mid = c // 2
    tend[mid] = bless - debt
    counts[mid] = torch.ceil(y[:, mid] + bless - debt).to(torch.int32)
    return torch.stack(counts, 1), torch.stack(tend, 1)


def slope_k(counts: torch.Tensor, fps: int) -> torch.Tensor:
    """K1/K4's slope k per voxel from int32 counts (N, C, H, W): the
    symmetric difference over the neighbouring bins, literal zero at the
    two boundary bins, normalised by voxel_step^2 and the count."""
    y = counts.float()
    dev = y.device
    voxel_step = 1.0 / fps / y.shape[1]
    k_raw = (y[:, 2:] - y[:, :-2]) * f32(0.5, dev)
    inner = k_raw / f32(voxel_step ** 2, dev) / (y[:, 1:-1] + f32(1e-8, dev))
    zero = torch.zeros_like(y[:, :1])
    return torch.cat([zero, inner, zero], dim=1)


def _tap_sum(y: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """sum_{dy,dx} taps[dy, dx] * y shifted, over zero padding, the taps
    added in one fixed row-major order. On integer counts with power-of-two
    (or unit) taps every partial sum is exact in f32, so no order of XLA's
    can round differently."""
    k = taps.shape[0]
    h, w = y.shape[-2:]
    pad = k // 2
    yp = F.pad(y, (pad, pad, pad, pad))
    acc = None
    for dy in range(k):
        for dx in range(k):
            term = yp[:, :, dy:dy + h, dx:dx + w]
            if taps[dy, dx] != 1.0:
                term = term * f32(taps[dy, dx], y.device)
            acc = term if acc is None else acc + term
    return acc


_WEIGHTED = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0


def _pool_counts(y: torch.Tensor, pooling_type: str, kernel_size: int) -> torch.Tensor:
    """Spatial pooling of (N, C, H, W) counts before the slope fit
    (`ldati.py:150`): 'avg' is the k x k box sum over zero padding times
    f32(1/k^2) (XLA's form of the division by the constant k*k);
    'weighted' the 3x3 [1 2 1; 2 4 2; 1 2 1] / 16 kernel."""
    if pooling_type == "none":
        return y
    if pooling_type == "weighted":
        return _tap_sum(y, _WEIGHTED)
    if pooling_type == "avg":
        return _tap_sum(y, np.ones((kernel_size, kernel_size))) * f32(
            1.0 / kernel_size ** 2, y.device)
    raise ValueError(f"unknown pooling_type {pooling_type!r}")


def slope_params(counts_f: torch.Tensor, fps: int, *, pooling_type: str = "none",
                 pooling_kernel_size: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel linear-density parameters (k, b), each (N, C, H, W) f32,
    of the grid path (`ldati.py:177`): k = k_raw / voxel_step^2 / (y +
    1e-8) with k_raw = (y[c+1] - y[c-1]) / 2, zero at the boundary bins,
    and b = 1/voxel_step - voxel_step*k/2 so the density integrates to 1.

    As XLA:CPU compiles it: the division by the constant voxel_step^2 is a
    multiply by its f32 reciprocal, and with 'avg' pooling the multiply by
    1/k^2 fuses into its two consumers as FMAs, k_raw's difference
    fma(S[c+1], 1/k^2, -y[c-1]) and the denominator fma(S, 1/k^2, 1e-8),
    S the box sums. A tiny nonzero k_raw sends the inverse CDF through its
    cancelling branch, so these roundings move timestamps by whole bins."""
    y = counts_f.float()
    dev = y.device
    eps = f32(1e-8, dev)
    if pooling_type == "avg":
        ks = pooling_kernel_size
        inv_kk = np.float32(1.0 / ks ** 2)
        box = _tap_sum(y, np.ones((ks, ks)))
        y = box * f32(inv_kk, dev)
        diff = fma32(box[:, 2:], inv_kk, -y[:, :-2])
        den = fma32(box, inv_kk, eps)
    else:
        y = _pool_counts(y, pooling_type, pooling_kernel_size)
        diff = y[:, 2:] - y[:, :-2]
        den = y + eps
    voxel_step = 1.0 / fps / y.shape[1]
    zero = torch.zeros_like(y[:, :1])
    k_raw = torch.cat([zero, diff * f32(0.5, dev), zero], dim=1)
    inv_vs2 = np.float32(1.0) / np.float32(voxel_step ** 2)
    k = k_raw * f32(inv_vs2, dev) / den
    return k, _b_of_k(k, voxel_step)


def inverse_cdf_ts(u: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                   voxel_step: float, *, fuse_square: bool = False) -> torch.Tensor:
    """Sample t in [0, voxel_step] from density k*t + b given uniform u;
    k == 0 falls back to uniform. The discriminant b*b + (2k)*u, clamped
    at 0, takes one rounding less than written: XLA:CPU contracts one of
    its two products into an FMA, (2k)*u after the generation kernels and
    b*b (`fuse_square`) on the grid path."""
    dev = u.device
    if fuse_square:
        disc = fma32(b, b, (k * f32(2.0, dev)) * u)
    else:
        disc = fma32(k * f32(2.0, dev), u, b * b)
    disc = torch.clamp(disc, min=0.0)
    one = f32(1.0, dev)
    # torch's vectorised f32 sqrt on the CPU is not correctly rounded; the
    # f64 root rounded to f32 is
    t = (torch.sqrt(disc.double()).float() - b) / torch.where(k == 0, one, k)
    return torch.where(k == 0, u * f32(voxel_step, dev), t)


def _b_of_k(k: torch.Tensor, voxel_step: float) -> torch.Tensor:
    """Intercept b = 1/vs - vs*k/2 of the density, so it integrates to 1."""
    return fma32(k, -np.float32(voxel_step / 2), f32(1.0 / voxel_step, k.device))


# ---------------------------------------------------------------------------
# Configuration gate and draws
# ---------------------------------------------------------------------------

def supports_rows(p: int, h: int, w: int, *, fps: int, c: int = 10,
                  additional_events_strategy: str = "slope",
                  pooling_type: str = "none", use_v3: bool = True) -> bool:
    """Whether the v3 core runs: asked for (use_v3) and the packed key holds
    the chain µs and the voxel ids; the take_v3 gate of the JAX
    `sample_events` (`ldati.py:1210`)."""
    max_rel_us = int(1.0 / fps / (c - 1) * 1e6) + 2
    return (use_v3 and additional_events_strategy in STRATEGIES
            and pooling_type in POOLINGS
            and max_rel_us <= (1 << (31 - vox_bits_of(p, h, w))) - 2)


def check_config(cfg: SamplerConfig, p: int, c: int, h: int, w: int) -> None:
    """Raise unless the port covers this sampler configuration. Where the
    packed key cannot hold the voxel ids (e.g. 260x346 at 13 fps or less,
    or wider than 1008 px at 30 fps) the v2 core runs."""
    if cfg.additional_events_strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, "
                         f"got {cfg.additional_events_strategy!r}")
    if cfg.pooling_type not in POOLINGS:
        raise ValueError(f"pooling_type must be one of {POOLINGS}, "
                         f"got {cfg.pooling_type!r}")
    if c != 10:
        raise NotImplementedError(f"LDATI expects 10 time bins, got {c}")
    if cfg.multi_cap >= 1 << 22:
        raise ValueError(f"multi_cap={cfg.multi_cap} must fit the 22-bit slot field "
                         "of the multi-pool ordering key")


def make_draw(seed: int, chunk: int, device) -> Draw:
    """Production draws: U[0, 1) f32 from a `torch.Generator` on `device`
    whose seed is a pure function of (seed, chunk, j)."""

    def draw(j: int, shape) -> torch.Tensor:
        state = np.random.SeedSequence([seed, chunk, j]).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        return torch.rand(tuple(shape), generator=g, device=device,
                          dtype=torch.float32)

    return draw


def _gen_kernel_route(cfg: SamplerConfig) -> Optional[str]:
    """'compact' (K1), 'pack' (K4) or None (the grid path), the gate of
    the JAX `sample_events` without its TPU scratch-size predicates."""
    strategy = cfg.additional_events_strategy
    if (cfg.pooling_type != "none" or cfg.bidirectional
            or strategy not in ("none", "slope")
            or (strategy == "slope" and cfg.max_events_per_voxel <= 1)):
        return None
    return "compact" if cfg.use_gen_compact else "pack"


# ---------------------------------------------------------------------------
# The v2 core: one flat (timestamp, voxel) sort per frame (ldati.py:220-570)
# ---------------------------------------------------------------------------

def frame_order_voxels(a: torch.Tensor, bb: int, p: int, cb: int, h: int,
                       w: int) -> torch.Tensor:
    """(B*P, C, H, W)-shaped per-voxel data -> (B, C*P*H*W) in the per-frame
    voxel order (C, P_flipped, H, W): OFF before ON within a bin
    (`ldati.py:572`)."""
    a = torch.flip(a.reshape(bb, p, cb, h, w), [1]).transpose(1, 2)
    return a.reshape(bb, cb * p * h * w)


def _top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row of a non-negative int32
    (B, N) score, in `lax.top_k`'s order: score descending, the lower index
    first on ties. The (score, N-1-index) pairs are unique int64 keys, so
    the order does not rest on how `torch.topk` breaks ties."""
    n = score.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=score.device)
    comp = (score.to(torch.int64) << 32) | (n - 1 - idx)
    return torch.topk(comp, k, dim=1, sorted=True).indices.to(torch.int32)


def _tier_v2(j: int, pool: int) -> int:
    """Slots the pool offers slot j (`ldati.py:286-289`): the whole pool up
    to j = 3, then halving with a 4096 floor. Not the v3 core's tiers."""
    return pool if j <= 3 else min(pool, max(pool >> (j - 3), 4096))


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx.to(torch.int64))


def compact_frame_events(emit_count: torch.Tensor, ts_fn, draw: Draw, *,
                         max_events_per_voxel: int, max_multi_voxels: int,
                         capacity: int):
    """Sort-compact every event of each frame into a capacity-wide buffer in
    timestamp order (`ldati.py:220`), for B frames at once.

    emit_count (B, V) int32 is the events each voxel emits. Every voxel
    with emit_count > 0 gives its slot-0 event; the voxels with
    emit_count >= 2 form a pool of max_multi_voxels that gives slots 1 ..
    mepv-1, chosen by top-k of the extra count (of whole 16-voxel blocks by
    their largest extra when V and the pool are multiples of 16 and the
    pool is smaller than V), slot j taking a prefix of the pool
    (`_tier_v2`). `ts_fn(j, u, vox_idx)` maps slot j and the (B, n) draws u
    to int32 µs; vox_idx is None for slot 0 over every voxel, else the
    (B, n) pool voxels. The (key, voxel) pairs are sorted stably, so ties
    keep the candidates' order: slot 0 by voxel, then each tier in pool
    order, then the padding.

    Returns (t_us (B, capacity), vox_id (B, capacity), count (B,),
    dropped (B,)): every event beyond the pool, the tiers or the capacity
    is counted in dropped."""
    bb, v = emit_count.shape
    dev = emit_count.device
    vox_ids = torch.arange(v, dtype=torch.int32, device=dev).expand(bb, v)
    u0 = draw(0, (bb, v))
    key_parts = [torch.where(emit_count > 0, ts_fn(0, u0, None), INVALID)]
    id_parts = [vox_ids]
    emitted = (emit_count > 0).sum(dim=1, dtype=torch.int32)

    if max_events_per_voxel > 1:
        pool = min(max_multi_voxels, v)
        extra = torch.clamp(emit_count - 1, min=0)
        block = 16
        if v % block == 0 and pool % block == 0 and pool < v:
            block_score = extra.reshape(bb, v // block, block).amax(dim=2)
            blk = _top_k_indices(block_score, pool // block)
            pool_idx = (blk[:, :, None] * block
                        + torch.arange(block, dtype=torch.int32, device=dev)
                        ).reshape(bb, pool)
        else:
            pool_idx = _top_k_indices(extra, pool)
        pool_extra = _gather(extra, pool_idx)
        for j in range(1, max_events_per_voxel):
            n_j = _tier_v2(j, pool)
            u = draw(j, (bb, n_j))
            valid_j = pool_extra[:, :n_j] >= j
            key_parts.append(torch.where(valid_j, ts_fn(j, u, pool_idx[:, :n_j]), INVALID))
            id_parts.append(pool_idx[:, :n_j])
            emitted = emitted + valid_j.sum(dim=1, dtype=torch.int32)

    all_keys = torch.cat(key_parts, dim=1)
    all_ids = torch.cat(id_parts, dim=1)
    if all_keys.shape[1] < capacity:                     # tiny inputs
        pad = capacity - all_keys.shape[1]
        all_keys = F.pad(all_keys, (0, pad), value=INVALID)
        all_ids = F.pad(all_ids, (0, pad))
    sorted_keys, perm = torch.sort(all_keys, dim=1, stable=True)
    sorted_ids = torch.gather(all_ids, 1, perm[:, :capacity])
    count = torch.clamp(emitted, max=capacity)
    dropped = emit_count.sum(dim=1, dtype=torch.int32) - count
    return sorted_keys[:, :capacity], sorted_ids, count, dropped


def compact_dispatch(emit_count: torch.Tensor, ts_fn, draw: Draw, *, bin_start_us: torch.Tensor,
                     cb: int, seg: int, max_rel_us: int, max_events_per_voxel: int,
                     max_multi_voxels: int, capacity: int,
                     use_binned_compaction: bool = False):
    """The v2 compaction of B frames (`ldati.py:320`): the binned route
    (`compact_frame_events_binned`) when asked for and the sub-bin µs
    (max_rel_us) and the within-bin voxel ids (seg) fit one int32 key,
    else the flat sort (`compact_frame_events`). The binned route's pool a
    bin is max_multi_voxels / cb, clamped to [128, 8192]."""
    ts_bits = _bits(max_rel_us + 3)
    if use_binned_compaction and ts_bits + _bits(max(seg, 2)) <= 31:
        return compact_frame_events_binned(
            emit_count, ts_fn, bin_start_us, draw, cb=cb, seg=seg, ts_bits=ts_bits,
            max_events_per_voxel=max_events_per_voxel, capacity=capacity,
            pool_bin=min(max(max_multi_voxels // cb, 128), 8192))
    return compact_frame_events(emit_count, ts_fn, draw,
                                max_events_per_voxel=max_events_per_voxel,
                                max_multi_voxels=max_multi_voxels, capacity=capacity)


def _searchsorted_right(offsets: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row r: the last i with offsets[r, i] <= q[r, :] (0 below the first),
    int32; offsets non-decreasing along each row."""
    r = torch.searchsorted(offsets.contiguous(), q.contiguous(), right=True, out_int32=True)
    return torch.clamp(r - 1, min=0)


def compact_frame_events_binned(emit_count: torch.Tensor, ts_fn, bin_start_us: torch.Tensor,
                                draw: Draw, *, cb: int, seg: int, ts_bits: int,
                                max_events_per_voxel: int, capacity: int, tile: int = 2048,
                                cap_bin: Optional[int] = None, pool_bin: Optional[int] = None):
    """The v2 compaction with one packed int32 key a candidate, sorted per
    bin (`ldati.py:371`), for B frames of bin-major (B, cb*seg) emit counts.

    The key is (µs past the bin start, clipped to ts_bits) << vox_bits | the
    voxel's id within its bin. (1) The slot-0 keys of each bin are sorted
    in tiles of `tile`; (2) the tiles' valid prefixes are gathered into a
    (cb, cap_bin) buffer; (3) the slot-0 events of voxels that emit two or
    more are sorted to the front of the bin, and the first pool_bin of them
    give slots 1 .. mepv-1; (4) each bin's slot-0 and extra keys are sorted
    and (5) the bins' valid prefixes gathered into capacity slots: the bins
    are time-ordered, so the stream is too. The only equal keys are INVALID
    or the same (µs, voxel) twice, so no sort needs to be stable.

    Draws: draw(0, (B, cb*seg)) over every voxel, draw(j, (B, cb*pool_bin))
    for slot j over the pool, bin-major. `ts_fn` and the returns are those
    of `compact_frame_events`; bin_start_us (cb,) int32 decodes the keys.
    Events past cap_bin, the pool or capacity are counted in dropped.

    Needs ts_bits + bits(seg) <= 31; `compact_dispatch` gates on it. The
    gate is the v3 core's within one (the v3 key's voxel id spans both
    polarities of a bin, as seg does here): at 260x346 (seg 179,920, 18
    bits) 30 fps passes (12 + 18) and 10 fps fails (14 + 18). So the route
    never serves a geometry the v2 core takes by the v3 gate: it serves
    `sample_events(use_v3=False)` and the ablation samplers, when asked
    for."""
    bb = emit_count.shape[0]
    dev = emit_count.device
    i32 = torch.int32
    vox_bits = _bits(max(seg, 2))
    if ts_bits + vox_bits > 31:
        raise ValueError(f"ts_bits {ts_bits} + vox_bits {vox_bits} exceed the 31-bit key")
    vox_mask = (1 << vox_bits) - 1
    ts_cap = (1 << ts_bits) - 2
    if cap_bin is None:
        cap_bin = min(_round_up(max(capacity // cb, 1024), 128), _round_up(seg, tile))
    pool_bin = min(4096 if pool_bin is None else pool_bin, cap_bin)
    n_tiles = -(-seg // tile)
    seg_pad = n_tiles * tile
    starts = bin_start_us.view(1, cb, 1)
    bin_base = torch.arange(cb, dtype=i32, device=dev).view(1, cb, 1) * seg

    def rel_us(abs_ts_us):
        return torch.clamp(abs_ts_us.reshape(bb, cb, -1) - starts, 0, ts_cap)

    # 1. slot-0 keys, sorted in tiles
    u0 = draw(0, (bb, cb * seg))
    keys0 = torch.where(emit_count.reshape(bb, cb, seg) > 0,
                        (rel_us(ts_fn(0, u0, None)) << vox_bits)
                        | torch.arange(seg, dtype=i32, device=dev), INVALID)
    keys0 = F.pad(keys0, (0, seg_pad - seg), value=INVALID)
    tiles = torch.sort(keys0.reshape(-1, tile), dim=1).values.reshape(bb * cb, seg_pad)

    # 2. the tiles' valid prefixes gathered into (cb, cap_bin) a frame
    tile_counts = (tiles.reshape(bb * cb, n_tiles, tile) != INVALID).sum(dim=2, dtype=i32)
    bin_total = tile_counts.sum(dim=1, dtype=i32)
    tile_off = torch.cumsum(tile_counts, dim=1, dtype=i32) - tile_counts
    q = torch.arange(cap_bin, dtype=i32, device=dev).expand(bb * cb, cap_bin)
    r = _searchsorted_right(tile_off, q)
    flat_idx = torch.clamp(r * tile + q - _gather(tile_off, r), 0, seg_pad - 1)
    compacted = torch.where(q < bin_total[:, None], _gather(tiles, flat_idx), INVALID)
    compacted = compacted.reshape(bb, cb, cap_bin)
    emitted = torch.clamp(bin_total, max=cap_bin).reshape(bb, cb).sum(dim=1, dtype=i32)

    rows = [compacted]
    if max_events_per_voxel > 1:
        def emit_of(keys):
            vox = torch.clamp((keys & vox_mask) + bin_base, 0, cb * seg - 1)
            em = _gather(emit_count, vox.reshape(bb, -1)).reshape(keys.shape)
            return vox, torch.where(keys != INVALID, em, 0)

        # 3. the multi-event pool: a sort keeps the slot-0 time order
        _, slot_emit = emit_of(compacted)
        pool = torch.sort(torch.where(slot_emit >= 2, compacted, INVALID),
                          dim=2).values[:, :, :pool_bin]
        pool_vox, pool_emit = emit_of(pool)
        pool_local = pool & vox_mask
        for j in range(1, max_events_per_voxel):
            u = draw(j, (bb, cb * pool_bin))
            live = pool_emit > j
            rel = rel_us(ts_fn(j, u, pool_vox.reshape(bb, -1)))
            rows.append(torch.where(live, (rel << vox_bits) | pool_local, INVALID))
            emitted = emitted + live.sum(dim=(1, 2), dtype=i32)

    # 4. one sort a bin; 5. the bins' valid prefixes into capacity slots
    rows = torch.sort(torch.cat(rows, dim=2), dim=2).values
    row_len = rows.shape[2]
    row_counts = (rows != INVALID).sum(dim=2, dtype=i32)
    off = torch.cumsum(row_counts, dim=1, dtype=i32) - row_counts
    qq = torch.arange(capacity, dtype=i32, device=dev).expand(bb, capacity)
    rb = _searchsorted_right(off, qq)
    flat = torch.clamp(rb * row_len + qq - _gather(off, rb), 0, cb * row_len - 1)
    out = _gather(rows.reshape(bb, -1), flat)
    count = torch.clamp(emitted, max=capacity)
    valid = qq < count[:, None]
    t_us = torch.where(valid, (out >> vox_bits) + bin_start_us[rb.long()], INVALID)
    vox_id = torch.where(valid, (out & vox_mask) + rb * seg, 0)
    dropped = emit_count.sum(dim=1, dtype=i32) - count
    return t_us, vox_id, count, dropped


def _compact_one_frame(emit_count, chain_ts_us, is_chain, k, b, bin_start_s, bin_start_us,
                       draw: Draw, *, strategy: str, voxel_step: float, cb: int, seg: int,
                       max_events_per_voxel: int, max_multi_voxels: int, capacity: int):
    """LDATI's slot -> timestamp rule on the v2 compaction (`ldati.py:521`),
    for B frames of (B, V) per-voxel data: slot 0 is the chain timestamp of
    a count-1 voxel and a draw otherwise, slots >= 1 are draws; 'slope'
    draws from the linear density, 'random' keeps raw U[0, 1) seconds past
    the bin start, 'none' emits the chain timestamps alone. Through
    `compact_dispatch` with the flat route, as in the JAX package; 'random'
    spans the whole frame, too wide for the binned route's key."""
    dev = emit_count.device
    us = f32(1e6, dev)

    def additional_us(u, kk, bb_, bins):
        t_add = inverse_cdf_ts(u, kk, bb_, voxel_step, fuse_square=True) \
            if strategy == "slope" else u
        return ((t_add + bins) * us).to(torch.int32)

    def ts_fn(j, u, vox_idx):
        if strategy == "none":
            return chain_ts_us if vox_idx is None else _gather(chain_ts_us, vox_idx)
        if vox_idx is None:
            return torch.where(is_chain, chain_ts_us, additional_us(u, k, b, bin_start_s))
        return additional_us(u, _gather(k, vox_idx), _gather(b, vox_idx),
                             _gather(bin_start_s, vox_idx))

    max_rel_us = int(1e6) if strategy == "random" else int(voxel_step * 1e6) + 2
    return compact_dispatch(
        emit_count, ts_fn, draw, bin_start_us=bin_start_us, cb=cb, seg=seg,
        max_rel_us=max_rel_us,
        max_events_per_voxel=1 if strategy == "none" else max_events_per_voxel,
        max_multi_voxels=max_multi_voxels, capacity=capacity)


def _sample_events_v2(voxels: torch.Tensor, draw: Draw, cfg: SamplerConfig, *, t0: float,
                      max_multi_voxels: int) -> EventStream:
    """The non-v3 tail of the JAX `sample_events` (`ldati.py:1118-1207`):
    relocation and slope on the grid, per-voxel emit counts, the per-frame
    voxel order, and the v2 compaction of each frame."""
    from v2ce_toolbox_tpu_torch.ops.gen import bin_constants, tend_scale

    bb, p, c, h, w = voxels.shape
    n, cb = bb * p, c - 1
    dev = voxels.device
    fps = cfg.fps
    mepv = cfg.max_events_per_voxel
    strategy = cfg.additional_events_strategy
    voxel_step = 1.0 / fps / cb

    counts, tendency = relocate_counts(voxels.float().reshape(n, c, h, w),
                                       bidirectional=cfg.bidirectional)
    bs_np, bs_us_np = bin_constants(cb, fps, t0)
    bs = torch.from_numpy(bs_np).to(dev).view(1, cb, 1, 1)
    bs_us = torch.from_numpy(bs_us_np).to(dev)
    if strategy == "none" and t0 == 0:
        # XLA:CPU contracts the other product of `tend * scale + bin * vs`
        # when nothing else reads the bin starts
        iota = torch.arange(cb, dtype=torch.float32, device=dev).view(1, cb, 1, 1)
        chain = fma32(iota, np.float32(voxel_step), tendency * f32(tend_scale(cb, fps), dev))
    else:
        chain = fma32(tendency, tend_scale(cb, fps), bs)
    chain_ts_us = (chain * f32(1e6, dev)).to(torch.int32)
    if strategy == "slope":
        k, b = slope_params(counts.float(), fps, pooling_type=cfg.pooling_type,
                            pooling_kernel_size=cfg.pooling_kernel_size)
    else:
        k = b = torch.zeros_like(tendency)

    is_chain = counts == 1
    if strategy == "none":
        emit = is_chain.to(torch.int32)
        cap_dropped = torch.zeros_like(counts)
    else:
        emit = torch.where(is_chain, 1, torch.clamp(counts, max=mepv)).clamp(min=0)
        cap_dropped = torch.where(counts > mepv, counts - mepv, 0)

    def fo(a):
        return frame_order_voxels(a, bb, p, cb, h, w)

    t_us, vox_id, count, dropped = _compact_one_frame(
        fo(emit), fo(chain_ts_us), fo(is_chain), fo(k), fo(b),
        fo(bs.expand(n, cb, h, w)), bs_us, draw, strategy=strategy, voxel_step=voxel_step,
        cb=cb, seg=p * h * w, max_events_per_voxel=mepv if strategy != "none" else 1,
        max_multi_voxels=max_multi_voxels, capacity=cfg.event_capacity)
    return decode_event_stream(t_us, vox_id, count,
                               dropped + fo(cap_dropped).sum(dim=1, dtype=torch.int32),
                               p, h, w)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def _frame_order(a: torch.Tensor, bb: int, p: int, cb: int, h: int, w: int,
                 pre_ordered: bool) -> torch.Tensor:
    """Per-voxel (N, cb, ...) data -> (B, cb, P_flipped*H*W): OFF before ON
    within a bin (`ldati.py:572`). A pre-ordered grid is already laid out
    (B, cb, P_flipped*H, W)."""
    if pre_ordered:
        return a.reshape(bb, cb, p * h * w)
    return frame_order_voxels(a, bb, p, cb, h, w).reshape(bb, cb, p * h * w)


def _grid_candidates(voxels: torch.Tensor, draw: Draw, cfg: SamplerConfig, t0: float):
    """The generation of the grid path (`ldati.py:1118-1151` and
    `:727-772`): candidate keys and payloads as (B*cb, P*H*W) rows, and the
    per-frame emit and over-mepv drop totals."""
    from v2ce_toolbox_tpu_torch.ops.gen import bin_constants, tend_scale

    bb, p, c, h, w = voxels.shape
    cb = c - 1
    dev = voxels.device
    fps = cfg.fps
    mepv = cfg.max_events_per_voxel
    strategy = cfg.additional_events_strategy
    voxel_step = 1.0 / fps / cb
    vox_bits = vox_bits_of(p, h, w)
    ts_cap = (1 << (31 - vox_bits)) - 2
    pre_ordered = cfg.pooling_type == "none"
    if pre_ordered:
        y = torch.flip(voxels.float(), [1]).transpose(1, 2).reshape(bb, c, p * h, w)
    else:
        y = voxels.float().reshape(bb * p, c, h, w)

    counts, tendency = relocate_counts(y, bidirectional=cfg.bidirectional)
    bs_np, bs_us_np = bin_constants(cb, fps, t0)
    bs = torch.from_numpy(bs_np).to(dev).view(1, cb, 1, 1)
    bs_us = torch.from_numpy(bs_us_np).to(dev).view(1, cb, 1, 1)
    chain_ts_us = (fma32(tendency, tend_scale(cb, fps), bs)
                   * f32(1e6, dev)).to(torch.int32)
    if strategy == "slope":
        k, b = slope_params(counts.float(), fps, pooling_type=cfg.pooling_type,
                            pooling_kernel_size=cfg.pooling_kernel_size)
    else:
        k = b = torch.zeros_like(tendency)

    use_multi = strategy != "none" and mepv > 1
    wide = strategy == "random"
    defer_draw = use_multi or wide
    is_chain = counts == 1
    if strategy == "none":
        emit = is_chain.to(torch.int32)
    else:
        emit = torch.where(is_chain, 1, torch.clamp(counts, max=mepv)).clamp(min=0)
    if strategy == "none" or defer_draw:
        ts0 = chain_ts_us
    else:
        # slope with mepv == 1: the slot-0 draw happens on the grid
        u0 = draw(0, tuple(counts.shape))
        t_add = inverse_cdf_ts(u0, k, b, voxel_step, fuse_square=True)
        bin_start_s = bs_us.float() * f32(1e-6, dev)
        ts0 = torch.where(is_chain, chain_ts_us,
                          ((t_add + bin_start_s) * f32(1e6, dev)).to(torch.int32))
    rel0 = torch.clamp(ts0 - bs_us, 0, ts_cap)
    if defer_draw:
        rel0 = torch.where(is_chain, rel0, 0)       # drawn after compaction

    def order(a):
        return _frame_order(a, bb, p, cb, h, w, pre_ordered)

    emit_f = order(emit)
    vox_iota = torch.arange(p * h * w, dtype=torch.int32, device=dev)
    keys0 = torch.where(emit_f > 0, (order(rel0) << vox_bits) | vox_iota, INVALID)
    kx = None
    if defer_draw:
        # 'random' with mepv == 1 runs no tiers but still needs the deferred
        # wide draw, so extra keeps marking counts >= 2
        xcap = 255 if (wide and mepv == 1) else mepv - 1
        extra = torch.clamp(counts - 1, min=0).clamp(max=min(xcap, 255))
        kx = order((k.view(torch.int32) & ~0xFF) | extra).reshape(bb * cb, -1)
    total_emit = emit_f.sum(dim=(1, 2), dtype=torch.int32)
    if strategy == "none":
        drop = torch.zeros((bb,), dtype=torch.int32, device=dev)
    else:
        drop = order(torch.where(counts > mepv, counts - mepv, 0)).sum(
            dim=(1, 2), dtype=torch.int32)
    return keys0.reshape(bb * cb, -1), kx, total_emit, drop


def sample_events(voxels: torch.Tensor, draw: Draw, cfg: SamplerConfig, *,
                  t0: float = 0.0, return_rows: bool = False,
                  max_multi_voxels: int = 1 << 16, use_v3: bool = True):
    """Sample a timestamped event stream from predicted voxels.

    Args:
      voxels: (B, 2, 10, H, W) float32 voxels (P index 0 = ON).
      draw: uniform provider, see the module docstring.
      cfg: sampler settings; `cfg.fps` sets the bin width.
      t0: start of the chunk in seconds, added to the bin starts.
      return_rows: hand back the post-sort rows instead of the stream.
      max_multi_voxels: the v2 core's pool of multi-event voxels a frame.
        The v2 core runs where the packed key cannot hold the voxel ids
        (`supports_rows`): per-frame buffers of width event_capacity
        sorted by timestamp over the whole frame.
      use_v3: False sends every configuration to the v2 core.
    Returns:
      With return_rows: rel (B*9, W) int32 µs within the row's bin, sorted
      ('random': in draw order of rel), INVALID tail; gvox (B*9, W) int32
      frame-level voxel id (bin*P*H*W + P-flipped id), 0 past the valid
      prefix; emit (B,) and drop (B,) int32 per-frame emitted-candidate
      and over-mepv totals. Otherwise an EventStream of per-frame buffers
      of width min(event_capacity, 9*W rounded up to 128), timestamps in
      int32 µs sorted per bin, INT32_MAX past count.
    """
    from v2ce_toolbox_tpu_torch.ops.gen import gen_compact, gen_pack

    bb, p, c, h, w = voxels.shape
    check_config(cfg, p, c, h, w)
    if not supports_rows(p, h, w, fps=cfg.fps, c=c,
                         additional_events_strategy=cfg.additional_events_strategy,
                         pooling_type=cfg.pooling_type, use_v3=use_v3):
        if return_rows:
            raise ValueError("return_rows needs the v3 sampler core: the packed key must "
                             "hold the voxel ids (supports_rows)")
        return _sample_events_v2(voxels, draw, cfg, t0=t0,
                                 max_multi_voxels=max_multi_voxels)
    dev = voxels.device
    cb = c - 1
    fps = cfg.fps
    mepv = cfg.max_events_per_voxel
    multi_cap = cfg.multi_cap
    strategy = cfg.additional_events_strategy
    seg = p * h * w
    vox_bits = vox_bits_of(p, h, w)
    vox_mask = (1 << vox_bits) - 1
    ts_cap = (1 << (31 - vox_bits)) - 2
    voxel_step = 1.0 / fps / cb
    use_multi = strategy != "none" and mepv > 1
    wide = strategy == "random"
    defer_draw = use_multi or wide
    wide_cap = int(1e6) + int(voxel_step * 1e6) + 2

    route = _gen_kernel_route(cfg)
    fuse_square = route is None
    gen_kw = dict(fps=fps, mepv=mepv, vox_bits=vox_bits, strategy=strategy, t0=t0)
    if route == "compact":
        chain_keys, ckx, _, _, total_emit, cap_drop = gen_compact(
            voxels, cap_bin=cfg.cap_bin, chunk=CHUNK, **gen_kw)
    else:
        if route == "pack":
            keys0, kx0, total_emit, cap_drop = gen_pack(voxels, **gen_kw)
        else:
            keys0, kx0, total_emit, cap_drop = _grid_candidates(voxels, draw, cfg, t0)
        chain_keys, pays, _, _ = compact_rows(
            keys0, [kx0] if kx0 is not None else [], cap=cfg.cap_bin, chunk=CHUNK,
            algo="place")
        ckx = pays[0] if pays else None
    rows_n = chain_keys.shape[0]

    if defer_draw:
        # deferred slot-0 draw of the non-chain voxels, on the compacted
        # rows; bin starts recompute per row with the JAX float expressions
        u0 = draw(0, tuple(chain_keys.shape))
        if wide:
            t_add = u0                            # raw U[0, 1) seconds
        else:
            k_c = (ckx & ~0xFF).view(torch.float32)
            t_add = inverse_cdf_ts(u0, k_c, _b_of_k(k_c, voxel_step), voxel_step,
                                   fuse_square=fuse_square)
        rb = (torch.arange(rows_n, device=dev) % cb).float()[:, None]
        bs_us_row = ((rb * f32(voxel_step, dev) + f32(t0, dev))
                     * f32(1e6, dev)).to(torch.int32)
        bs_s_row = bs_us_row.float() * f32(1e-6, dev)
        ts_draw = ((t_add + bs_s_row) * f32(1e6, dev)).to(torch.int32)
        rel_draw = torch.clamp(ts_draw - bs_us_row, 0, wide_cap if wide else ts_cap)
        non_chain = (chain_keys != INVALID) & ((ckx & 0xFF) > 0)
        if wide:
            chain_rel = torch.where(chain_keys != INVALID, chain_keys >> vox_bits, INVALID)
            chain_rel = torch.where(non_chain, rel_draw, chain_rel)
        else:
            chain_keys = torch.where(
                non_chain, (rel_draw << vox_bits) | (chain_keys & vox_mask), chain_keys)

    rows: List[torch.Tensor] = [chain_keys]
    if wide:
        rows_rel = [chain_rel]
        rows_vox = [torch.where(chain_keys != INVALID, chain_keys & vox_mask, 0)]

    if use_multi:
        # multi-event pool, ordered by extra count descending (stable)
        multi_in = torch.where(((ckx & 0xFF) > 0) & (chain_keys != INVALID),
                               chain_keys, INVALID)
        mchunk = min(CHUNK, max(128, (multi_cap // 128) * 128))
        m_keys, (mkx,), _, _ = compact_rows(multi_in, [ckx], cap=multi_cap, chunk=mchunk,
                                            algo="place")
        mc = m_keys.shape[1]
        m_valid = m_keys != INVALID
        mvox0 = torch.where(m_valid, m_keys & vox_mask, 0)
        m_extra0 = torch.where(m_valid, mkx & 0xFF, 0)
        order = ((255 - m_extra0) << 22) | torch.arange(mc, dtype=torch.int32, device=dev)
        perm = torch.sort(order, dim=1, stable=True).indices
        mkx = torch.gather(mkx, 1, perm)
        mvox = torch.gather(mvox0, 1, perm)
        m_extra = mkx & 0xFF
        mk_f = (mkx & ~0xFF).view(torch.float32)
        mb_f = _b_of_k(mk_f, voxel_step)

        def tier(j: int) -> int:
            return mc if j <= 2 else min(mc, max(multi_cap >> (j - 2), 128))

        for j in range(1, mepv):
            n_j = tier(j)
            u = draw(j, (rows_n, n_j))
            valid_j = m_extra[:, :n_j] >= j
            if wide:
                ts_j = ((u + bs_s_row[:, :1]) * f32(1e6, dev)).to(torch.int32)
                rel = torch.clamp(ts_j - bs_us_row[:, :1], 0, wide_cap)
                rows_rel.append(torch.where(valid_j, rel, INVALID))
                rows_vox.append(mvox[:, :n_j])
                continue
            t_j = inverse_cdf_ts(u, mk_f[:, :n_j], mb_f[:, :n_j], voxel_step,
                                 fuse_square=fuse_square)
            rel = torch.clamp((t_j * f32(1e6, dev)).to(torch.int32), 0, ts_cap)
            rows.append(torch.where(valid_j, (rel << vox_bits) | mvox[:, :n_j], INVALID))

    row_bin = (torch.arange(rows_n, dtype=torch.int32, device=dev) % cb)[:, None]
    if wide:
        # two-word sort: rel-µs is the single key, the voxel id rides as
        # payload; the stable sort keeps the bin-major voxel order on ties
        rel_in = torch.cat(rows_rel, dim=1)
        vox_in = torch.cat(rows_vox, dim=1)
        if cfg.sort_cap is not None and cfg.sort_cap < rel_in.shape[1]:
            rel_in, (vox_in,), _, _ = compact_rows(
                rel_in, [vox_in], cap=cfg.sort_cap, chunk=min(CHUNK, cfg.sort_cap),
                algo="place")
        rel_only, perm = torch.sort(rel_in, dim=1, stable=True)
        vox_s = torch.gather(vox_in, 1, perm)
        gvox = torch.where(rel_only != INVALID, vox_s + row_bin * seg, 0)
    else:
        merged = torch.cat(rows, dim=1)
        if cfg.sort_cap is not None and cfg.sort_cap < merged.shape[1]:
            merged, _, _, _ = compact_rows(merged, (), cap=cfg.sort_cap,
                                           chunk=min(CHUNK, cfg.sort_cap), algo="place")
        merged = torch.sort(merged, dim=1).values
        valid = merged != INVALID
        gvox = torch.where(valid, (merged & vox_mask) + row_bin * seg, 0)
        rel_only = torch.where(valid, merged >> vox_bits, INVALID)
    if return_rows:
        return rel_only, gvox, total_emit, cap_drop

    # the frame stream is the concatenation of the rows' valid prefixes
    # (K3); it never holds more than cb * W events, so the capacity is
    # clamped to that bound rounded up to 128 (`ldati.py:943-968`)
    cap_eff = min(cfg.event_capacity, -(-cb * rel_only.shape[1] // 128) * 128)
    out_rel, (out_vox,), kept, _ = merge_sorted_rows(rel_only, [gvox], nb=cb, cap=cap_eff)
    out_bin = torch.clamp(out_vox // seg, max=cb - 1)
    bin_start_dec = ((out_bin.float() * f32(voxel_step, dev) + f32(t0, dev))
                     * f32(1e6, dev)).to(torch.int32)
    t_us = torch.where(out_rel != INVALID, out_rel + bin_start_dec, INVALID)
    return decode_event_stream(t_us, out_vox, kept, total_emit - kept + cap_drop, p, h, w)


def sample_rows(voxels: torch.Tensor, draw: Draw, cfg: SamplerConfig, *, t0: float = 0.0):
    """`sample_events(..., return_rows=True)`: the post-sort (frame*bin, W)
    rows the fused wire path consumes."""
    return sample_events(voxels, draw, cfg, t0=t0, return_rows=True)


def decode_event_stream(t_us: torch.Tensor, vox_id: torch.Tensor, count: torch.Tensor,
                        dropped: torch.Tensor, p: int, h: int, w: int) -> EventStream:
    """Flat (C, P_flipped, H, W) voxel ids -> (x, y, polarity), with the
    slots at or past count masked (`ldati.py:584`)."""
    hw = h * w
    rem = vox_id % (p * hw)
    yx = rem % hw
    valid = torch.arange(t_us.shape[1], device=t_us.device)[None, :] < count[:, None]
    return EventStream(t_us=torch.where(valid, t_us, INVALID),
                       x=(yx % w).to(torch.int16), y=(yx // w).to(torch.int16),
                       p=(rem // hw).to(torch.int8), count=count, dropped=dropped)


def sample_voxel_statistical(y, t0: float = 0, fps: int = 30, pooling_type: str = "none",
                             pooling_kernel_size: int = 3,
                             additional_events_strategy: str = "slope",
                             bidirectional: bool = False, draw: Optional[Draw] = None,
                             max_events_per_voxel: int = 16,
                             max_multi_voxels: int = 1 << 16, capacity: int = 1 << 19,
                             device="cuda") -> List[np.recarray]:
    """Drop-in counterpart of the reference entry point
    (`ldati.py:1226`): a (B, P, C, H, W) voxel grid -> a list of B
    recarrays sorted by timestamp. Draws default to `make_draw(0, 0,
    device)`. Pipelines call `sample_events` and keep the stream on the
    device."""
    v = torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor) else y)
    v = v.to(device=device, dtype=torch.float32).contiguous()
    cfg = SamplerConfig(fps=fps, additional_events_strategy=additional_events_strategy,
                        pooling_type=pooling_type, pooling_kernel_size=pooling_kernel_size,
                        bidirectional=bidirectional,
                        max_events_per_voxel=max_events_per_voxel,
                        event_capacity=capacity)
    if draw is None:
        draw = make_draw(0, 0, v.device)
    return to_recarrays(sample_events(v, draw, cfg, t0=float(t0),
                                      max_multi_voxels=max_multi_voxels))
