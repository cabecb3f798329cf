"""LDATI — the stage-2 statistical event sampler, 'slope' strategy.

Port of the path that `v2ce_toolbox_tpu/ops/ldati.py:sample_events(...,
return_rows=True)` takes with the fused generation kernel
(`ldati.py:1047-1085` -> `_sample_events_v3` with `packed_rows`):

  1. K1 (`ops/gen.gen_compact`): relocation, slope and candidate keys,
     compacted to (frame*bin, cap_bin) rows;
  2. the deferred slot-0 draw for the non-chain voxels, on those rows;
  3. the multi-event pool through K2, ordered by extra count, descending;
  4. the tier rows of additional events (halving widths from slot 3);
  5. the `sort_cap` pre-sort compaction through K2;
  6. one stable sort per (frame, bin) row;
  7. the rows handed back as (rel µs, global voxel id).

Uniform draws come from a provider `draw(j, shape) -> Tensor`: j is the
JAX `fold_in` index (0 for slot 0, j for tier j), so tests can feed the
JAX draws and compare bytes. In production `make_draw` seeds a
`torch.Generator` from (run seed, chunk, j), so a repeated dispatch draws
the same numbers.

Float contract: every f32 expression follows the JAX op order, and the
two multiply-adds that XLA contracts into FMA are single-rounding here
too: the intercept `1/vs - k * (vs/2)` and the inverse-CDF discriminant
`(2k) * u + b*b`. `fma32` computes them with a single rounding on any
device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows

Draw = Callable[[int, Tuple[int, ...]], torch.Tensor]


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


# ---------------------------------------------------------------------------
# Relocation and slope (ldati.py:73, :177)
# ---------------------------------------------------------------------------

def relocate_counts(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward debt-carrying relocation: (N, C, H, W) voxels -> int32 counts
    and f32 tendency, each (N, C-1, H, W)."""
    eps = f32(1e-6, y.device)
    debt = torch.zeros_like(y[:, 0])
    counts, tend = [], []
    for ci in range(y.shape[1] - 1):
        avail = y[:, ci] - debt
        cf = torch.ceil(avail - eps)
        debt = cf - avail
        counts.append(cf.to(torch.int32))
        tend.append(debt)
    # fold the final input bin into the last output bin, truncating
    counts[-1] = counts[-1] + (y[:, -1] - debt).to(torch.int32)
    return torch.stack(counts, 1), torch.stack(tend, 1)


def slope_k(counts: torch.Tensor, fps: int) -> torch.Tensor:
    """Linear-density slope k per voxel from int32 counts (N, C, H, W): the
    symmetric difference over the neighbouring bins, zero at the two
    boundary bins, normalised by voxel_step^2 and the count."""
    y = counts.float()
    dev = y.device
    voxel_step = 1.0 / fps / y.shape[1]
    k_raw = (y[:, 2:] - y[:, :-2]) * f32(0.5, dev)
    inner = k_raw / f32(voxel_step ** 2, dev) / (y[:, 1:-1] + f32(1e-8, dev))
    zero = torch.zeros_like(y[:, :1])
    return torch.cat([zero, inner, zero], dim=1)


def inverse_cdf_ts(u: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                   voxel_step: float) -> torch.Tensor:
    """Sample t in [0, voxel_step] from density k*t + b given uniform u;
    k == 0 falls back to uniform. The discriminant is clamped at 0."""
    dev = u.device
    disc = torch.clamp(fma32(k * f32(2.0, dev), u, b * b), min=0.0)
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

def check_config(cfg: SamplerConfig, p: int, c: int, h: int, w: int) -> None:
    """Raise unless the port covers this sampler configuration: the fused
    'slope' path with no pooling, forward relocation and mepv > 1
    (ldati.supports_rows + driver._fused_flatten_ok). The other modes are
    ROADMAP item 9."""
    if (cfg.additional_events_strategy != "slope" or cfg.pooling_type != "none"
            or cfg.bidirectional or cfg.max_events_per_voxel <= 1):
        raise NotImplementedError(
            "the PyTorch port samples only strategy='slope' with pooling "
            "'none', forward relocation and max_events_per_voxel > 1; the "
            "other sampler modes are ROADMAP item 9 (got "
            f"{cfg.additional_events_strategy!r}, {cfg.pooling_type!r}, "
            f"bidirectional={cfg.bidirectional}, "
            f"mepv={cfg.max_events_per_voxel})")
    if c != 10:
        raise NotImplementedError(f"LDATI expects 10 time bins, got {c}")
    seg_bits = max(int(np.ceil(np.log2(max(p * h * w, 2)))), 1)
    if int(1.0 / cfg.fps / (c - 1) * 1e6) + 2 > (1 << (31 - seg_bits)) - 2:
        raise NotImplementedError(
            f"the packed key cannot hold {p}x{h}x{w} voxel ids at fps={cfg.fps}")
    if cfg.multi_cap >= 1 << 22:
        raise ValueError(f"multi_cap={cfg.multi_cap} must fit the 22-bit slot "
                         "field of the multi-pool ordering key")


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


# ---------------------------------------------------------------------------
# The sampler core
# ---------------------------------------------------------------------------

def sample_rows(voxels: torch.Tensor, draw: Draw, cfg: SamplerConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample the post-sort (frame*bin, W) rows of one chunk.

    Args:
      voxels: (B, 2, 10, H, W) float32 voxels (P index 0 = ON).
      draw: uniform provider, see the module docstring.
      cfg: sampler settings; `cfg.fps` sets the bin width.
    Returns:
      rel (B*9, W) int32 µs within the row's bin, sorted, INVALID tail;
      gvox (B*9, W) int32 frame-level voxel id (bin*P*H*W + P-flipped id),
      0 past the valid prefix; emit (B,) and drop (B,) int32 per-frame
      emitted-candidate and over-mepv totals — the return_rows outputs of
      sample_events.
    """
    from v2ce_toolbox_tpu_torch.ops.gen import gen_compact

    bb, p, c, h, w = voxels.shape
    check_config(cfg, p, c, h, w)
    dev = voxels.device
    cb = c - 1
    fps = cfg.fps
    mepv = cfg.max_events_per_voxel
    multi_cap = cfg.multi_cap
    seg = p * h * w
    vox_bits = max(int(np.ceil(np.log2(max(seg, 2)))), 1)
    vox_mask = (1 << vox_bits) - 1
    ts_cap = (1 << (31 - vox_bits)) - 2
    voxel_step = 1.0 / fps / cb
    chunk = 16384

    chain_keys, ckx, _, _, total_emit, cap_drop = gen_compact(
        voxels, fps=fps, mepv=mepv, vox_bits=vox_bits, cap_bin=cfg.cap_bin,
        chunk=chunk)
    rows_n = chain_keys.shape[0]

    # deferred slot-0 draw of the non-chain voxels, on the compacted rows;
    # bin starts recompute per row with the JAX float expressions
    u0 = draw(0, tuple(chain_keys.shape))
    k_c = (ckx & ~0xFF).view(torch.float32)
    t_add = inverse_cdf_ts(u0, k_c, _b_of_k(k_c, voxel_step), voxel_step)
    rb = (torch.arange(rows_n, device=dev) % cb).float()[:, None]
    bs_us_row = ((rb * f32(voxel_step, dev)) * f32(1e6, dev)).to(torch.int32)
    bs_s_row = bs_us_row.float() * f32(1e-6, dev)
    ts_draw = ((t_add + bs_s_row) * f32(1e6, dev)).to(torch.int32)
    rel_draw = torch.clamp(ts_draw - bs_us_row, 0, ts_cap)
    non_chain = (chain_keys != INVALID) & ((ckx & 0xFF) > 0)
    chain_keys = torch.where(non_chain, (rel_draw << vox_bits) | (chain_keys & vox_mask),
                             chain_keys)

    # multi-event pool, ordered by extra count descending (stable)
    multi_in = torch.where(non_chain, chain_keys, INVALID)
    mchunk = min(chunk, max(128, (multi_cap // 128) * 128))
    m_keys, (mkx,), _, _ = compact_rows(multi_in, [ckx], cap=multi_cap, chunk=mchunk)
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

    rows = [chain_keys]
    for j in range(1, mepv):
        n_j = tier(j)
        u = draw(j, (rows_n, n_j))
        t_j = inverse_cdf_ts(u, mk_f[:, :n_j], mb_f[:, :n_j], voxel_step)
        rel = torch.clamp((t_j * f32(1e6, dev)).to(torch.int32), 0, ts_cap)
        rows.append(torch.where(m_extra[:, :n_j] >= j,
                                (rel << vox_bits) | mvox[:, :n_j], INVALID))

    merged = torch.cat(rows, dim=1)
    if cfg.sort_cap is not None and cfg.sort_cap < merged.shape[1]:
        merged, _, _, _ = compact_rows(merged, (), cap=cfg.sort_cap,
                                       chunk=min(chunk, cfg.sort_cap))
    merged = torch.sort(merged, dim=1).values

    valid = merged != INVALID
    row_bin = (torch.arange(rows_n, dtype=torch.int32, device=dev) % cb)[:, None]
    gvox = torch.where(valid, (merged & vox_mask) + row_bin * seg, 0)
    rel_only = torch.where(valid, merged >> vox_bits, INVALID)
    return rel_only, gvox, total_emit, cap_drop
