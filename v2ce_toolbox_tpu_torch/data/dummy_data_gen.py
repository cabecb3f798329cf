"""Synthetic packet fixture generator (reference:
train/scripts/tools/dummy_data_gen.py:10-39): random packets with the exact
production schema, so the training loop is smoke-testable without MVSEC.

A copy of `v2ce_toolbox_tpu/data/dummy_data_gen.py` (numpy only)."""

from __future__ import annotations

import os
import os.path as op
import pickle

import numpy as np

from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE


def make_packet(rng: np.random.RandomState, height=260, width=346,
                num_frames=17, events_per_frame=1000) -> dict:
    packet = {
        "images": rng.randint(0, 255, (num_frames, height, width),
                              dtype=np.uint8),
        "gyroscopes": rng.rand(num_frames, 3),
        "accelerometers": rng.rand(num_frames, 3),
        "physical_att": rng.rand(num_frames - 1, height, width),
        "optical_flow": rng.rand(num_frames - 1, 2, height, width),
        "acc_flow": rng.rand(num_frames - 1, 2, height, width),
        "timestamps": np.sort(rng.randint(0, 1000000, (num_frames,))),
    }
    event_packets = []
    for _ in range(num_frames - 1):
        ev = np.zeros((events_per_frame,), dtype=EVENT_DTYPE)
        ev["timestamp"] = np.sort(rng.randint(0, 1000000, (events_per_frame,)))
        ev["x"] = rng.randint(0, width, (events_per_frame,))
        ev["y"] = rng.randint(0, height, (events_per_frame,))
        ev["polarity"] = rng.randint(0, 2, (events_per_frame,))
        event_packets.append(ev)
    packet["events"] = event_packets
    return packet


def make_correlated_packet(rng: np.random.RandomState, height=260,
                           width=346, num_frames=17,
                           max_events_per_frame=4096) -> dict:
    """A packet whose events are a FUNCTION of its frames: moving
    bright-disc/edge footage with one event per changed pixel (DVS-style
    |diff| threshold), so the GT voxels are learnable from the image
    pairs — the fixture for the overfit-to-metric demonstration
    (tools/overfit_demo.py). Same schema as make_packet."""
    yy, xx = np.mgrid[0:height, 0:width]
    cx, cy = rng.uniform(0.2, 0.8) * width, rng.uniform(0.2, 0.8) * height
    vx, vy = rng.uniform(-3, 3), rng.uniform(-2, 2)
    r = rng.uniform(0.12, 0.25) * min(height, width)
    edge0, ev_edge = rng.uniform(0, width), rng.uniform(-3, 3)
    imgs = []
    for t in range(num_frames):
        img = np.full((height, width), 40, np.float32)
        r2 = (xx - (cx + vx * t)) ** 2 + (yy - (cy + vy * t)) ** 2
        img += 150.0 * (r2 < r * r)
        band = (np.abs(xx - (edge0 + ev_edge * t) % width)
                < max(2, width * 0.04))
        img += 60.0 * band
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    images = np.stack(imgs)

    event_packets = []
    for t in range(num_frames - 1):
        diff = images[t + 1].astype(np.int32) - images[t].astype(np.int32)
        ys, xs = np.nonzero(np.abs(diff) > 20)
        n = min(len(ys), max_events_per_frame)
        sel = rng.permutation(len(ys))[:n]
        ev = np.zeros((n,), dtype=EVENT_DTYPE)
        ev["timestamp"] = np.sort(rng.randint(0, 1000000, (n,)))
        ev["x"] = xs[sel].astype(np.int16)
        ev["y"] = ys[sel].astype(np.int16)
        ev["polarity"] = (diff[ys[sel], xs[sel]] > 0).astype(np.int8)
        event_packets.append(ev)

    packet = {
        "images": images,
        "gyroscopes": rng.rand(num_frames, 3),
        "accelerometers": rng.rand(num_frames, 3),
        "physical_att": rng.rand(num_frames - 1, height, width),
        "optical_flow": rng.rand(num_frames - 1, 2, height, width),
        "acc_flow": rng.rand(num_frames - 1, 2, height, width),
        "timestamps": np.sort(rng.randint(0, 1000000, (num_frames,))),
        "events": event_packets,
    }
    return packet


def generate(data_dir: str, num_packets: int = 256, seed: int = 0,
             height=260, width=346, events_per_frame=1000,
             correlated: bool = False):
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(num_packets):
        with open(op.join(data_dir, f"{i:05d}.pkl"), "wb") as f:
            if correlated:
                pickle.dump(make_correlated_packet(rng, height, width), f)
            else:
                pickle.dump(make_packet(rng, height, width,
                                        events_per_frame=events_per_frame),
                            f)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="dummy_data")
    ap.add_argument("-n", "--num_packets", type=int, default=256)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--width", type=int, default=346)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate(args.data_dir, args.num_packets, args.seed, args.height,
             args.width)
    print(f"wrote {args.num_packets} packets to {args.data_dir}")
