"""AEDAT4 (DAVIS camera recordings) -> 16-frame training packets.

Equivalent of the reference converter
(reference: train/scripts/tools/event_chunk.py:10-142): frames + nearest
IMU sample per frame, events paired to [frame_t, frame_{t+1}) intervals
with leftover carry, dumped every `frames_per_sequence` frames.

Requires the `dv` package (also the reference's dependency,
event_chunk.py:6), which the package does not depend on: the import is
deferred so the rest of the data package stays usable.

A copy of `v2ce_toolbox_tpu/data/event_chunk.py` (numpy only).
"""

from __future__ import annotations

import os
import os.path as op
import pickle
from typing import Optional

import numpy as np

from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE


def event_chunk(path: str, out_dir: str, frames_per_sequence: int = 16,
                prefix: str = "sequence",
                max_sequences: Optional[int] = None) -> int:
    """Chunk an .aedat4 file into pkl packets; returns packets written."""
    try:
        from dv import AedatFile
    except ImportError as e:  # pragma: no cover - no dv installed
        raise ImportError(
            "event_chunk needs the `dv` package (python-dv) to read AEDAT4 "
            "files; install it or convert via MVSEC HDF5 instead "
            "(v2ce_toolbox_tpu_torch.data.mvsec)."
        ) from e

    os.makedirs(out_dir, exist_ok=True)

    with AedatFile(path) as f:
        frame_ts = np.array([fr.timestamp for fr in f["frames"]])
        imu_ts = np.array([pkg.timestamp for pkg in f["imu"]])

    # nearest preceding IMU sample per frame (reference: event_chunk.py:25-28)
    imu_idx = np.maximum(np.searchsorted(imu_ts, frame_ts, side="left") - 1, 0)
    acc, gyro = [], []
    with AedatFile(path) as f:
        imu_all = [(pkg.accelerometer, pkg.gyroscope) for pkg in f["imu"]]
    for i in imu_idx:
        acc.append(imu_all[i][0])
        gyro.append(imu_all[i][1])
    acc = np.asarray(acc)
    gyro = np.asarray(gyro)

    written = 0
    with AedatFile(path) as f:
        images, events, accs, gyros, ts_used = [], [], [], [], []
        leftover = None
        event_iter = f["events"].numpy()

        for idx, frame_pkg in enumerate(f["frames"]):
            t0 = frame_ts[idx]
            t1 = frame_ts[idx + 1] if idx + 1 < len(frame_ts) else t0 + 10**6
            paired = [] if leftover is None else [leftover]
            leftover = None
            while True:
                try:
                    pkt = next(event_iter)
                except StopIteration:
                    break
                inside = pkt[(pkt["timestamp"] >= t0) & (pkt["timestamp"] < t1)]
                if len(inside):
                    paired.append(inside)
                if pkt["timestamp"][-1] >= t1:
                    leftover = pkt[pkt["timestamp"] >= t1]
                    break

            if paired:
                raw = np.hstack(paired)
                ev = np.zeros(len(raw), dtype=EVENT_DTYPE)
                for field in ("timestamp", "x", "y", "polarity"):
                    ev[field] = raw[field]
            else:
                ev = np.zeros(0, dtype=EVENT_DTYPE)

            images.append(frame_pkg.image.squeeze())
            events.append(ev)
            accs.append(acc[idx])
            gyros.append(gyro[idx])
            ts_used.append(t0)

            if idx != 0 and idx % frames_per_sequence == 0:
                packet = {
                    "images": np.stack(images),
                    "events": events[:-1],
                    "accelerometers": np.vstack(accs),
                    "gyroscopes": np.vstack(gyros),
                    "timestamps": np.array(ts_used),
                }
                with open(op.join(out_dir, f"{prefix}-{written}.pkl"),
                          "wb") as fo:
                    pickle.dump(packet, fo)
                images, events = [images[-1]], [events[-1]]
                accs, gyros = [accs[-1]], [gyros[-1]]
                ts_used = [ts_used[-1]]
                written += 1
                if max_sequences and written >= max_sequences:
                    break
    return written


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--aedat_path", required=True)
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("--frames_per_sequence", type=int, default=16)
    ap.add_argument("--prefix", default="sequence")
    args = ap.parse_args()
    n = event_chunk(args.aedat_path, args.out_dir, args.frames_per_sequence,
                    args.prefix)
    print(f"wrote {n} packets to {args.out_dir}")
