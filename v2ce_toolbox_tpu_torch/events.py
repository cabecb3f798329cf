"""Event-stream containers and host-edge converters.

On the device an event stream is a struct of per-frame fixed-capacity
tensors with a validity count and an overflow counter (`EventStream`); the
on-disk record is the structured dtype of the CLI's npz output
(`EVENT_DTYPE`). Conversion happens only at the host boundary.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

EVENT_DTYPE = np.dtype(
    [("timestamp", "<i8"), ("x", "<i2"), ("y", "<i2"), ("polarity", "i1")]
)


class EventStream(NamedTuple):
    """A batch of per-frame fixed-capacity event buffers.

    All tensors share the leading frame axis B and the capacity E. Slots
    at or past count[b] are padding (timestamp INT32_MAX). Timestamps are
    int32 µs within the chunk; per-frame offsets are added on the host in
    int64.
    """

    t_us: torch.Tensor      # (B, E) int32, sorted ascending per frame
    x: torch.Tensor         # (B, E) int16, width index
    y: torch.Tensor         # (B, E) int16, height index
    p: torch.Tensor         # (B, E) int8, 1 = ON, 0 = OFF
    count: torch.Tensor     # (B,) int32, valid events per frame
    dropped: torch.Tensor   # (B,) int32, events lost to capacity limits

    @property
    def capacity(self) -> int:
        return self.t_us.shape[-1]


def to_recarrays(stream: EventStream, t0_offsets_us=None) -> List[np.recarray]:
    """An EventStream -> one recarray per frame, with optional (B,) int64
    per-frame offsets added to the timestamps."""
    t, x, y, p, count = (a.cpu().numpy() for a in
                         (stream.t_us, stream.x, stream.y, stream.p, stream.count))
    if t0_offsets_us is None:
        t0_offsets_us = np.zeros((t.shape[0],), np.int64)
    out = []
    for i in range(t.shape[0]):
        n = int(count[i])
        out.append(np.rec.fromarrays(
            [t[i, :n].astype(np.int64) + int(t0_offsets_us[i]),
             x[i, :n].astype(np.int16), y[i, :n].astype(np.int16),
             p[i, :n].astype(np.int8)],
            names=["timestamp", "x", "y", "polarity"]))
    return out


def concatenate_recarrays(recs: List[np.recarray]) -> np.ndarray:
    """Per-frame recarrays -> one stream."""
    return np.concatenate(recs)
