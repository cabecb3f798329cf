"""Stage-2 ablation samplers: the random/even baseline and pure slope.

Port of `v2ce_toolbox_tpu/ops/samplers.py` (the reference's
random_even_sample.py and pure_slope_sample.py), on the v2 core's
compaction (`ops/ldati.compact_dispatch`). Unlike LDATI they do not
relocate: each of the 10 bins keeps its value, floor(y) events are
emitted and the fraction gives one more with that probability.

Timestamp rules, delta = 1/(fps*C), C = 10:
  random:      every event uniform in [0, delta)
  even:        integer event j at j/(n+1)*delta; the Bernoulli event at
               n/(n+1)*delta
  pure_slope:  every event from the linear-density inverse CDF, with the
               slope of the unfolded voxel; bin 9 is folded into bin 8

Draws come from a provider `draw(j, shape)`: j = BERNOULLI gives the
(B*P, C, H, W) draw of the fractional events (the JAX package folds
10_001 into the chunk key), and j = 0 .. mepv-1 the (B, n) draws of the
compaction, row f from frame f (the chunk key split per frame, then j
folded in), as in `ops/ldati.compact_frame_events`. `ldati.make_draw`
serves both in production.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.events import EventStream, to_recarrays
from v2ce_toolbox_tpu_torch.ops.ldati import (
    Draw,
    _gather,
    compact_dispatch,
    decode_event_stream,
    f32,
    fma32,
    frame_order_voxels,
    inverse_cdf_ts,
    make_draw,
    slope_params,
)

BERNOULLI = 10_001
MODES = ("random", "even")


def _prepare(y: torch.Tensor):
    bb, p, c, h, w = y.shape
    return y.reshape(bb * p, c, h, w).float(), bb, p, c, h, w


def _bernoulli_emit(y: torch.Tensor, draw: Draw):
    """(integer events, emitted events) per voxel: floor(y) clipped at 0,
    plus one where the draw falls under the fraction."""
    int_part = torch.floor(y)
    bern = (draw(BERNOULLI, tuple(y.shape)) < y - int_part).to(torch.int32)
    n_int = torch.clamp(int_part, min=0).to(torch.int32)
    return n_int, n_int + bern


def _bin_starts(c: int, delta: float, t0: Optional[float], dev) -> torch.Tensor:
    """The (c,) f32 bin starts bin * delta + t0: with t0 left out (a
    constant 0) a product, else fma(bin, delta, t0), as XLA:CPU evaluates
    them (see `_bin_adder`)."""
    iota = torch.arange(c, dtype=torch.float32, device=dev)
    if t0 is None:
        return iota * f32(delta, dev)
    return fma32(iota, np.float32(delta), f32(t0, dev).expand(c))


def _bin_adder(fo, shape, delta: float, t0: Optional[float], dev):
    """add_bin(sub, vox_idx, q): sub plus the voxel's bin start, where q, if
    given, is the factor of sub = q * delta whose product XLA:CPU contracts
    into the sum, fma(q, delta, start).

    With t0 left out (a constant 0) the bin start is bin * delta, and over
    every voxel (vox_idx None) that product is the one contracted instead:
    fma(bin, delta, sub). With t0 given (a traced scalar, as the host-edge
    wrappers pass it) the bin start is fma(bin, delta, t0). Found by
    holding the samplers against XLA:CPU (tests/test_torch_samplers.py)."""
    c = shape[1]
    d = np.float32(delta)
    iota = torch.arange(c, dtype=torch.float32, device=dev)
    bins = _bin_starts(c, delta, t0, dev)
    bins_f = fo(bins.view(1, c, 1, 1).expand(shape))
    iota_f = fo(iota.view(1, c, 1, 1).expand(shape))

    def add_bin(sub, vox_idx, q=None):
        if vox_idx is None and t0 is None:
            return fma32(iota_f, d, sub)
        start = bins_f if vox_idx is None else _gather(bins_f, vox_idx)
        return sub + start if q is None else fma32(q, d, start)

    return add_bin


def _compact(emit: torch.Tensor, ts_fn, draw: Draw, *, bb: int, p: int, c: int, h: int,
             w: int, delta: float, t0: Optional[float], max_events_per_voxel: int,
             max_multi_voxels: int, capacity: int) -> EventStream:
    """Every frame through the v2 compaction (`compact_dispatch`, the flat
    route, as in the JAX package), decoded, with the events over
    max_events_per_voxel added to dropped."""
    dev = emit.device
    t_us, vox_id, count, dropped = compact_dispatch(
        frame_order_voxels(emit, bb, p, c, h, w), ts_fn, draw,
        bin_start_us=(_bin_starts(c, delta, t0, dev) * f32(1e6, dev)).to(torch.int32),
        cb=c, seg=p * h * w, max_rel_us=int(delta * 1e6) + 2,
        max_events_per_voxel=max_events_per_voxel, max_multi_voxels=max_multi_voxels,
        capacity=capacity)
    cap_drop = frame_order_voxels(torch.clamp(emit - max_events_per_voxel, min=0),
                                  bb, p, c, h, w).sum(dim=1, dtype=torch.int32)
    return decode_event_stream(t_us, vox_id, count, dropped + cap_drop, p, h, w)


def sample_events_baseline(voxels: torch.Tensor, draw: Draw, *, t0: Optional[float] = None,
                           fps: int = 30, mode: str = "random",
                           max_events_per_voxel: int = 16, max_multi_voxels: int = 1 << 16,
                           capacity: int = 1 << 19) -> EventStream:
    """Random/even baseline sampler (`samplers.py:48`): (B, 2, 10, H, W)
    voxels -> per-frame buffers of width capacity, sorted by timestamp."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    y, bb, p, c, h, w = _prepare(voxels)
    dev = y.device
    delta = 1.0 / (fps * c)
    n_int, emit = _bernoulli_emit(y, draw)

    def fo(a):
        return frame_order_voxels(a, bb, p, c, h, w)

    n_int_f = fo(n_int)
    add_bin = _bin_adder(fo, y.shape, delta, t0, dev)
    d = f32(delta, dev)

    def ts_fn(j, u, vox_idx):
        nv = n_int_f if vox_idx is None else _gather(n_int_f, vox_idx)
        if mode == "random":
            ts = add_bin(u * d, vox_idx, u)
        else:
            # where(j < n, j/(n+1)*delta, n/(n+1)*delta) is where(...) * delta;
            # its product is contracted in the pool's slots only
            nv_f = nv.float()
            den = nv_f + f32(1.0, dev)
            q = torch.where(j < nv, f32(j, dev) / den, nv_f / den)
            ts = add_bin(q * d, vox_idx, None if vox_idx is None else q)
        return (ts * f32(1e6, dev)).to(torch.int32)

    return _compact(emit, ts_fn, draw, bb=bb, p=p, c=c, h=h, w=w, delta=delta, t0=t0,
                    max_events_per_voxel=max_events_per_voxel,
                    max_multi_voxels=max_multi_voxels, capacity=capacity)


def sample_events_pure_slope(voxels: torch.Tensor, draw: Draw, *,
                             t0: Optional[float] = None,
                             fps: int = 30, pooling_type: str = "none",
                             pooling_kernel_size: int = 3, max_events_per_voxel: int = 16,
                             max_multi_voxels: int = 1 << 16,
                             capacity: int = 1 << 19) -> EventStream:
    """Pure-slope sampler (`samplers.py:120`): every event, integer or
    fractional, from the linear density whose slope comes from the
    unfolded voxel (voxel_step 1/(fps*10)); bin 9 folded into bin 8."""
    y, bb, p, c, h, w = _prepare(voxels)
    dev = y.device
    delta = 1.0 / (fps * c)
    k, b = slope_params(y, fps, pooling_type=pooling_type,
                        pooling_kernel_size=pooling_kernel_size)
    y = y.clone()
    y[:, c - 2] += y[:, c - 1]
    y[:, c - 1] = 0.0
    _, emit = _bernoulli_emit(y, draw)

    def fo(a):
        return frame_order_voxels(a, bb, p, c, h, w)

    k_f, b_f = fo(k), fo(b)
    add_bin = _bin_adder(fo, y.shape, delta, t0, dev)

    def ts_fn(j, u, vox_idx):
        if vox_idx is None:
            kk, bk = k_f, b_f
        else:
            kk, bk = _gather(k_f, vox_idx), _gather(b_f, vox_idx)
        sub = inverse_cdf_ts(u, kk, bk, delta, fuse_square=True)
        return (add_bin(sub, vox_idx) * f32(1e6, dev)).to(torch.int32)

    return _compact(emit, ts_fn, draw, bb=bb, p=p, c=c, h=h, w=w, delta=delta, t0=t0,
                    max_events_per_voxel=max_events_per_voxel,
                    max_multi_voxels=max_multi_voxels, capacity=capacity)


# -- host-edge wrappers (the reference's call signatures) ------------------

def _voxels_on(y, device) -> torch.Tensor:
    v = y if isinstance(y, torch.Tensor) else torch.from_numpy(np.asarray(y))
    return v.to(device=device, dtype=torch.float32).contiguous()


def sample_voxel_baseline(y, t0=0, fps=30, even=False, random=False,
                          draw: Optional[Draw] = None, device="cuda",
                          **kw) -> List[np.recarray]:
    """The reference's random_even_sample.py:118 entry (`samplers.py:194`):
    a (B, P, C, H, W) grid -> B recarrays sorted by timestamp. Draws
    default to `make_draw(0, 0, device)`."""
    if not (even or random):
        raise ValueError("give even=True or random=True")
    v = _voxels_on(y, device)
    stream = sample_events_baseline(v, draw or make_draw(0, 0, v.device), t0=float(t0),
                                    fps=fps, mode="even" if even else "random", **kw)
    return to_recarrays(stream)


def sample_voxel_pure_slope(y, t0=0, fps=30, pooling_type="none", pooling_kernel_size=3,
                            draw: Optional[Draw] = None, device="cuda",
                            **kw) -> List[np.recarray]:
    """The reference's pure_slope_sample.py:57 entry (`samplers.py:206`)."""
    v = _voxels_on(y, device)
    stream = sample_events_pure_slope(v, draw or make_draw(0, 0, v.device), t0=float(t0),
                                      fps=fps, pooling_type=pooling_type,
                                      pooling_kernel_size=pooling_kernel_size, **kw)
    return to_recarrays(stream)
