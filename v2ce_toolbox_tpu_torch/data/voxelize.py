"""Event-stream -> voxel-grid converters.

Equivalents of the reference's events_utils converters
(reference: train/scripts/utils/events_utils.py:70-260): temporal bilinear
splatting of each event into the two nearest time bins, with polarity-split
volume halves. Two implementations:

  - *_np: numpy (np.add.at) — used by the host data pipeline, where the
    reference also runs it (inside DataLoader workers).
  - gen_discretized_event_volume: torch `index_put_(accumulate=True)` over
    a fixed-capacity masked event buffer — the device version, used by
    metric/eval harnesses.

The numpy converters are copies of `v2ce_toolbox_tpu/data/voxelize.py`'s;
the device version is the port of its jnp one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _floor_ceil_delta(t_scaled: np.ndarray):
    """reference: events_utils.py:118-126 (calc_floor_ceil_delta)."""
    t_fl = np.floor(t_scaled + 1e-8)
    t_ce = np.ceil(t_scaled - 1e-8)
    t_ce_fake = np.floor(t_scaled) + 1
    dt_ce = t_scaled - t_fl
    dt_fl = t_ce_fake - t_scaled
    return (t_fl.astype(np.int64), dt_fl), (t_ce.astype(np.int64), dt_ce)


def gen_discretized_event_volume_np(
    events: np.ndarray, vol_size: Tuple[int, int, int]
) -> np.ndarray:
    """Structured events -> (2*num_bins, H, W) float volume
    (reference: events_utils.py:145-175). First half of the bin axis is
    positive (ON) events, second half negative."""
    volume = np.zeros(vol_size, np.float32)
    if len(events) == 0:
        return volume
    if len(events) >= 4096:
        # the np.add.at scatter below is the host data pipeline's hot
        # loop; the native splat (native/event_io.cpp v2ce_voxel_splat)
        # is the same arithmetic, bit-identical, in one compiled pass
        from v2ce_toolbox_tpu_torch.io.native import voxel_splat

        if voxel_splat(events, volume):
            return volume
    x = events["x"].astype(np.int64)
    y = events["y"].astype(np.int64)
    t = events["timestamp"].astype(np.float64)
    p = np.where(events["polarity"] == 0, -1, events["polarity"]).astype(np.int64)

    nb = vol_size[0] // 2
    t_min, t_max = t.min(), t.max()
    denom = max(t_max - t_min, 1e-12)
    t_scaled = np.clip((t - t_min) * ((nb - 1) / denom), 0, nb - 1)

    (t_fl, dt_fl), (t_ce, dt_ce) = _floor_ceil_delta(t_scaled)
    vol_mul = np.where(p < 0, nb, 0)
    flat = volume.reshape(-1)
    for tt, dt in ((t_fl, dt_fl), (t_ce, dt_ce)):
        inds = (vol_size[1] * vol_size[2]) * (tt + vol_mul) + vol_size[2] * y + x
        np.add.at(flat, inds, dt.astype(np.float32))
    return volume


def gen_discretized_event_volume(
    t_us: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    p: torch.Tensor,
    valid: torch.Tensor,
    vol_size: Tuple[int, int, int],
    t_min=None,
    t_max=None,
) -> torch.Tensor:
    """The device version over a fixed-capacity masked SoA event buffer
    (counterpart of the JAX package's jnp version), on the events' device.

    Args:
      t_us/x/y/p: (E,) event fields (p in {0, 1}); valid: (E,) bool mask.
      t_min/t_max: optional explicit window bounds (like the reference's
        gen_discretized_event_volume_from_tensor, events_utils.py:177-213);
        default = masked min/max.
    Returns:
      (2*num_bins, H, W) float32. Invalid events land in one extra slot
      past the volume, which is dropped.
    """
    nbins2, h, w = vol_size
    nb = nbins2 // 2
    dev = t_us.device
    t = t_us.to(torch.float32)
    inf = torch.tensor(float("inf"), device=dev)
    if t_min is None:
        t_min = torch.where(valid, t, inf).min()
    if t_max is None:
        t_max = torch.where(valid, t, -inf).max()
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    denom = torch.clamp(t_max - t_min, min=1e-12)
    t_scaled = torch.clamp((t - t_min) * ((nb - 1) / denom), 0, nb - 1)

    t_fl = torch.floor(t_scaled + 1e-8)
    t_ce = torch.ceil(t_scaled - 1e-8)
    dt_ce = t_scaled - t_fl
    dt_fl = torch.floor(t_scaled) + 1 - t_scaled

    vol_mul = torch.where(p > 0, 0, nb)
    base = (h * w) * vol_mul + w * y.to(torch.int64) + x.to(torch.int64)
    size = nbins2 * h * w
    flat = torch.zeros((size + 1,), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for tt, dt in ((t_fl, dt_fl), (t_ce, dt_ce)):
        inds = torch.where(valid, base + (h * w) * tt.to(torch.int64), size)
        flat.index_put_((inds,), torch.where(valid, dt, zero), accumulate=True)
    return flat[:size].reshape(vol_size)


def structured_events_to_voxel_grid(
    events: np.ndarray, num_bins: int, width: int, height: int
) -> np.ndarray:
    """Polarity-stacked (2, num_bins, H, W) bilinear voxel grid where the
    two leading channels hold the floor/ceil splat halves
    (reference: events_utils.py:215-260)."""
    voxel = np.zeros((2, num_bins, height, width), np.float32)
    if len(events) == 0:
        return voxel
    first, last = events[0]["timestamp"], events[-1]["timestamp"]
    delta = max(last - first, 1.0)
    ts = (num_bins - 1) * (events["timestamp"] - first) / delta
    xs = events["x"].astype(int)
    ys = events["y"].astype(int)
    pols = np.where(events["polarity"] == 0, -1,
                    events["polarity"]).astype(np.float32)
    tis = ts.astype(int)
    dts = ts - tis
    ok = tis < num_bins
    np.add.at(voxel[0].ravel(),
              xs[ok] + ys[ok] * width + tis[ok] * width * height,
              (pols * (1.0 - dts))[ok])
    ok = (tis + 1) < num_bins
    np.add.at(voxel[1].ravel(),
              xs[ok] + ys[ok] * width + (tis[ok] + 1) * width * height,
              (pols * dts)[ok])
    return voxel


def structured_events_to_voxel_stat(
    events: np.ndarray, num_bins: int, width: int, height: int
):
    """Per-voxel count / mean / std of in-bin timestamp offsets
    (reference: events_utils.py:333-358)."""
    delta_t = int(np.ceil(
        (events["timestamp"][-1] - events["timestamp"][0]) / num_bins))
    delta_t = max(delta_t, 1)
    ts = events["timestamp"] - events["timestamp"][0]
    tbs = np.minimum(ts // delta_t, num_bins - 1)
    trs = (ts % delta_t).astype(np.float64)
    ps = np.where(events["polarity"] == -1, 0, events["polarity"]).astype(int)
    xs, ys = events["x"].astype(int), events["y"].astype(int)

    shape = (2, num_bins, height, width)
    count = np.zeros(shape)
    s = np.zeros(shape)
    s2 = np.zeros(shape)
    np.add.at(count, (ps, tbs, ys, xs), 1)
    np.add.at(s, (ps, tbs, ys, xs), trs)
    np.add.at(s2, (ps, tbs, ys, xs), trs ** 2)
    mean = s / np.maximum(count, 1)
    var = (s2 - (s ** 2) / np.maximum(count, 1)) / np.maximum(count - 1, 1)
    return count, mean, np.sqrt(np.maximum(var, 0))


def accumulate_frame(
    events: np.ndarray, width: int, height: int, clip: int = 2
) -> np.ndarray:
    """DHP19-style signed accumulation frame, clipped
    (reference: events_utils.py:380-417, simplified to its used core)."""
    frame = np.zeros((height, width), np.float64)
    if len(events):
        pols = np.where(events["polarity"] == 0, -1,
                        events["polarity"]).astype(np.float64)
        np.add.at(frame, (events["y"].astype(int), events["x"].astype(int)),
                  pols)
    return np.clip(frame, -clip, clip)


def events_to_voxel_grid_np(
    events: np.ndarray, num_bins: int, width: int, height: int
) -> np.ndarray:
    """Signed single-volume variant (reference: events_utils.py:70-116):
    bilinear in time, polarity as +/-1 value sign, (num_bins, H, W)."""
    assert events.shape[1] == 4
    voxel_grid = np.zeros((num_bins, height, width), np.float32).ravel()
    if len(events) == 0:
        return voxel_grid.reshape((num_bins, height, width))

    last_stamp = events[-1, 0]
    first_stamp = events[0, 0]
    delta_t = max(last_stamp - first_stamp, 1e-12)

    ts = (num_bins - 1) * (events[:, 0] - first_stamp) / delta_t
    xs = events[:, 1].astype(int)
    ys = events[:, 2].astype(int)
    pols = events[:, 3].copy()
    pols[pols == 0] = -1

    tis = ts.astype(int)
    dts = ts - tis
    vals_left = pols * (1.0 - dts)
    vals_right = pols * dts

    valid = tis < num_bins
    np.add.at(voxel_grid,
              xs[valid] + ys[valid] * width + tis[valid] * width * height,
              vals_left[valid])
    valid = (tis + 1) < num_bins
    np.add.at(voxel_grid,
              xs[valid] + ys[valid] * width + (tis[valid] + 1) * width * height,
              vals_right[valid])
    return voxel_grid.reshape((num_bins, height, width))
