"""Stage-1 style scoring of external simulator event streams (ESIM, v2e).

The JAX package's `eval/baseline_metrics.py` with the port's voxelizer and
metrics: slice a simulator's event stream into the packet's frame
intervals (even time splits when frame timestamps are missing), voxelize
each interval like the GT, and score with the stage-1 voxel metrics
(BinaryMatch / BinaryMatchF1 / PoolMSE).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np


def slice_stream_to_frames(events: np.ndarray, num_frames: int = 16,
                           timestamps: Optional[np.ndarray] = None):
    """Split one event stream into per-frame streams, by explicit frame
    timestamps or into even time splits."""
    t = events["timestamp"]
    if timestamps is None:
        lo, hi = (t.min(), t.max() + 1) if len(t) else (0, 1)
        timestamps = np.linspace(lo, hi, num_frames + 1)
    return [events[(t >= timestamps[i]) & (t < timestamps[i + 1])]
            for i in range(num_frames)]


def voxelize_stream(events: np.ndarray, num_frames: int = 16, num_bins: int = 10,
                    frame_size=(260, 346), timestamps: Optional[np.ndarray] = None) -> np.ndarray:
    """(num_frames, 2*num_bins, H, W) voxels from one stream."""
    h, w = frame_size
    frames = slice_stream_to_frames(events, num_frames, timestamps)
    return np.stack([gen_discretized_event_volume_np(ev, (2 * num_bins, h, w))
                     for ev in frames], axis=0)


def score_stream_against_gt(
    pred_events: np.ndarray,
    gt_voxels: np.ndarray,
    timestamps: Optional[np.ndarray] = None,
    metrics: Sequence[str] = ("binarymatch", "binarymatchf1", "poolmse"),
) -> Dict[str, float]:
    """Voxelize a simulator stream and score it against GT voxels
    (L, 2*num_bins, H, W) in the reference layout. Returns {metric: float}."""
    import torch

    from v2ce_toolbox_tpu_torch.train.metrics import build_metric_suite

    L, c2, h, w = gt_voxels.shape
    pred = voxelize_stream(pred_events, L, c2 // 2, (h, w), timestamps)
    # metrics take channels-last (B, L, H, W, C)
    p = torch.from_numpy(np.ascontiguousarray(np.moveaxis(pred, 1, -1)[np.newaxis]))
    g = torch.from_numpy(np.ascontiguousarray(np.moveaxis(gt_voxels, 1, -1)[np.newaxis]))
    suite = build_metric_suite(metrics)
    return {name: float(fn(p.float(), g.float())) for name, fn in suite.items()}
