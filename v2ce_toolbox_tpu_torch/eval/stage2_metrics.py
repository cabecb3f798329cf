"""Stage-2 quality metrics: timestamp error against ground-truth events.

Port of `v2ce_toolbox_tpu/eval/stage2_metrics.py` (the reference's
train/scripts/stage2/stage2_metrics.py:22-88). The metric is numpy: the
predicted stream is sorted once by a packed (pixel, timestamp) int64 key
and every GT event finds its nearest prediction with two binary searches.

Per GT event: the least |dt| to a predicted event of the same polarity
within `search_range` pixels, clamped at 3 time bins (1e6/fps/10*3 µs),
the clamped events counted as overflow; returns [mean diff in µs,
overflow count].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_TS_PACK = 1 << 40  # > any µs timestamp of a packet

SAMPLERS = ("ldati", "ldati_bidirectional", "ldati_pool_avg", "ldati_pool_weighted",
            "random", "even", "slope")


def _pixel_id(x, y, p, height: int):
    return (np.int64(x) * height + np.int64(y)) * 2 + np.int64(p)


def ts_diff_metric(event_gt: np.ndarray, event_pred: np.ndarray, search_range: int = 0,
                   fps: int = 30, width: int = 346, height: int = 260) -> np.ndarray:
    """Per-GT-event nearest-timestamp error (µs) and overflow count.

    event_gt / event_pred: structured arrays with fields (timestamp, x, y,
    polarity); GT polarity may use -1 for OFF. Returns
    np.array([avg_diff_us, overflow_count])."""
    clamp = 1e6 / fps / 10 * 3
    if len(event_gt) == 0:
        return np.array([0.0, 0])
    gt_p = event_gt["polarity"].astype(np.int64)
    gt_p = np.where(gt_p == -1, 0, gt_p)
    if len(event_pred) == 0:
        return np.array([clamp, len(event_gt)])

    pred_pix = _pixel_id(event_pred["x"], event_pred["y"], event_pred["polarity"], height)
    pred_ts = event_pred["timestamp"].astype(np.int64)
    order = np.argsort(pred_pix * _TS_PACK + pred_ts)
    skey = (pred_pix * _TS_PACK + pred_ts)[order]
    sts = pred_ts[order]
    spix = pred_pix[order]

    gt_ts = event_gt["timestamp"].astype(np.int64)
    best = np.full(len(event_gt), np.inf)
    offsets = range(-search_range, search_range + 1)
    for dx in offsets:
        qx = event_gt["x"].astype(np.int64) + dx
        ok_x = (qx >= 0) & (qx < width)
        for dy in offsets:
            qy = event_gt["y"].astype(np.int64) + dy
            ok = ok_x & (qy >= 0) & (qy < height)
            qpix = (qx * height + qy) * 2 + gt_p
            pos = np.searchsorted(skey, qpix * _TS_PACK + gt_ts)
            right = np.minimum(pos, len(skey) - 1)       # same pixel, ts >= query
            d_right = np.where(spix[right] == qpix, np.abs(sts[right] - gt_ts), np.inf)
            left = np.maximum(pos - 1, 0)                # same pixel, ts < query
            d_left = np.where((spix[left] == qpix) & (pos > 0),
                              np.abs(sts[left] - gt_ts), np.inf)
            best = np.minimum(best, np.where(ok, np.minimum(d_right, d_left), np.inf))

    # no neighbour found: the reference's 1e6 placeholder
    best = np.where(np.isinf(best), 1e6, best)
    overflow = best > clamp
    best = np.where(overflow, clamp, best)
    return np.array([best.mean(), int(overflow.sum())])


def event_count_ratio(event_gt: np.ndarray, event_pred: np.ndarray) -> float:
    """Pred/GT event-count ratio."""
    return len(event_pred) / max(len(event_gt), 1)


def roundtrip_voxel_consistency(voxel: np.ndarray, event_pred: np.ndarray,
                                fps: int = 30) -> Dict[str, float]:
    """Re-bin one frame's sampled events and compare with the relocated
    integer counts of its (2, 10, H, W) voxel (the reference's check,
    stage2_metrics.py:187-190): abs-difference statistics and totals."""
    from v2ce_toolbox_tpu_torch.ops.ldati import relocate_counts

    p2, c, h, w = voxel.shape
    counts, _ = relocate_counts(torch.from_numpy(
        np.ascontiguousarray(voxel, dtype=np.float32)).reshape(p2, c, h, w))
    counts = counts.numpy()                              # (2, 9, H, W)
    cb = c - 1
    grid = np.zeros_like(counts)
    if len(event_pred):
        bin_us = 1e6 / fps / cb
        b = np.clip(((event_pred["timestamp"] + 1) / bin_us).astype(int), 0, cb - 1)
        pol = np.where(event_pred["polarity"] > 0, 0, 1)  # P index 0 = ON
        np.add.at(grid, (pol, b, event_pred["y"].astype(int), event_pred["x"].astype(int)), 1)
    diff = np.abs(grid - np.maximum(counts, 0))
    return {"abs_diff_mean": float(diff.mean()), "abs_diff_max": float(diff.max()),
            "pred_total": int(grid.sum()),
            "relocated_total": int(np.maximum(counts, 0).sum())}


def evaluate_samplers_on_frame(gt_events: np.ndarray, voxel: np.ndarray,
                               samplers: Sequence[str] = ("ldati", "random", "even", "slope"),
                               fps: int = 30, search_range: int = 0,
                               draws: Optional[Callable[[str], Callable]] = None,
                               device="cuda") -> Dict[str, Tuple[float, int, float]]:
    """Score each sampler on one frame's (2, 10, H, W) voxel: (avg ts error
    µs, overflow, pred/GT count ratio), the reference's CSV row triple.
    `draws(name)` gives each sampler's draw provider; by default every
    sampler draws from `make_draw(0, 0, device)`."""
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_voxel_statistical
    from v2ce_toolbox_tpu_torch.ops.samplers import (
        sample_voxel_baseline,
        sample_voxel_pure_slope,
    )

    if draws is None:
        def draws(name):
            return make_draw(0, 0, device)
    v = voxel[np.newaxis]                                # (1, 2, 10, H, W)
    ldati_kw = {"ldati": {}, "ldati_bidirectional": dict(bidirectional=True),
                "ldati_pool_avg": dict(pooling_type="avg"),
                "ldati_pool_weighted": dict(pooling_type="weighted")}
    h, w = voxel.shape[-2:]
    out = {}
    for name in samplers:
        kw = dict(fps=fps, draw=draws(name), device=device)
        if name in ldati_kw:
            rec = sample_voxel_statistical(v, **ldati_kw[name], **kw)[0]
        elif name in ("random", "even"):
            rec = sample_voxel_baseline(v, **{name: True}, **kw)[0]
        elif name == "slope":
            rec = sample_voxel_pure_slope(v, **kw)[0]
        else:
            raise ValueError(f"unknown sampler {name!r}; one of {SAMPLERS}")
        diff, overflow = ts_diff_metric(gt_events, rec, search_range=search_range, fps=fps,
                                        width=w, height=h)
        out[name] = (float(diff), int(overflow), event_count_ratio(gt_events, rec))
    return out
