"""Physical-attention ground-truth generation.

Numpy re-implementation of the reference physical attention pipeline
(reference: train/scripts/utils/physical_att.py:8-213): ratio of the real
event-count frame to the v2e-style log-intensity residual, 8x8 block
pooling, gaussian blur, clip/normalize. skimage's block_reduce is replaced
by an exact reshape-mean (inputs are multiples of the pool size in
practice; ragged edges are averaged over the partial block like
block_reduce with func=np.mean and cval=0 — we pad with zeros and divide by
the full block area, matching skimage's default behavior).

A copy of `v2ce_toolbox_tpu/utils/physical_att.py` (numpy and scipy only).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter

from v2ce_toolbox_tpu_torch.utils.v2e import lin_log


def gen_mosaic_frame(frame: np.ndarray, pool_size: int = 8) -> np.ndarray:
    """Block-mean downsample (reference: physical_att.py:8-31 which uses
    skimage.measure.block_reduce(func=np.mean))."""
    frame = frame.astype(np.float32)
    h, w = frame.shape
    ph = -h % pool_size
    pw = -w % pool_size
    if ph or pw:
        frame = np.pad(frame, ((0, ph), (0, pw)))
    h2, w2 = frame.shape
    return frame.reshape(h2 // pool_size, pool_size,
                         w2 // pool_size, pool_size).mean(axis=(1, 3))


def _event_xy(events):
    """Accept structured event arrays or plain (N, 4) [ts, x, y, p]."""
    if events.dtype.names:
        return events["x"].astype(int), events["y"].astype(int)
    return events[:, 1].astype(int), events[:, 2].astype(int)


def gen_event_frame(events, frame_size) -> np.ndarray:
    """Per-pixel event counts (reference: physical_att.py:33-52)."""
    h, w = frame_size
    count = np.zeros((h, w), np.int64)
    if len(events):
        x, y = _event_xy(events)
        np.add.at(count, (y, x), 1)
    return count


def gen_top_k_mask(input_array: np.ndarray, k: int) -> np.ndarray:
    """Mask of the K largest values (reference: physical_att.py:45-62)."""
    threshold = np.partition(input_array.flatten(), -k)[-k]
    return input_array >= threshold


def physical_attention_generation(events, frames, pool_size: int = 8,
                                  ceiling: float = 10) -> np.ndarray:
    """Event-count / log-residual ratio attention map in [0, 1]
    (reference: physical_att.py:107-146)."""
    event_frame = gen_event_frame(events, frames.shape[1:3])
    ef_patches = gen_mosaic_frame(event_frame, pool_size)
    ef_patches[ef_patches < 0.05] = 0

    frames = frames.astype(np.float64) + 1e-6
    delta_lg = np.abs(lin_log(frames[1]) - lin_log(frames[0]))
    lg_patches = gen_mosaic_frame(delta_lg, pool_size)

    ratio = ef_patches / (lg_patches + 1e-3)
    ratio = np.clip(ratio, 0, ceiling * 2)
    ratio = gaussian_filter(ratio, sigma=1)
    ratio = np.clip(ratio, 0, ceiling)
    if ratio.max() != ratio.min():
        return ratio / ceiling
    return np.zeros_like(ratio)


def physical_attention_generation_advanced(events, frames, pool_size=8,
                                           ceiling: float = 5) -> np.ndarray:
    """Min-max-normalized variant (reference: physical_att.py:150-193)."""
    event_frame = gen_event_frame(events, frames.shape[1:3])
    ef_patches = gen_mosaic_frame(event_frame, pool_size)
    ef_patches[ef_patches < 0.05] = 0

    frames = frames.astype(np.float64) + 1e-6
    delta_lg = np.abs(lin_log(frames[1]) - lin_log(frames[0]))
    lg_patches = gen_mosaic_frame(delta_lg, pool_size)

    ratio = ef_patches / (lg_patches + 1e-3)
    ratio = np.clip(ratio, 0, ceiling * 2)
    ratio = gaussian_filter(ratio, sigma=1)
    ratio = np.clip(ratio, 0, ceiling)
    if ratio.max() != ratio.min():
        return (ratio - ratio.min()) / (ratio.max() - ratio.min())
    return np.zeros_like(ratio)


def physical_attention_batch_generation(events, frames, pool_size=8,
                                        advanced=False, ceiling=5):
    """(reference: physical_att.py:196-213)."""
    fn = (physical_attention_generation_advanced if advanced
          else physical_attention_generation)
    kw = {"ceiling": ceiling} if advanced else {}
    return np.stack([fn(events[i], frames[i], pool_size, **kw)
                     for i in range(frames.shape[0])], axis=0)
