"""Voxel-value statistics of a packet directory: the mean, std and
percentiles of the nonzero GT voxel values.

    python -m v2ce_toolbox_tpu_torch.tools.time_voxel_stat_calc --data_dir packets/

Prints the report of `tools/time_voxel_stat_calc.py`, line for line. The
voxels are the numpy host voxelizer's, as in the JAX package: no device
work.
"""

import argparse
import os
import os.path as op
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--max_files", type=int, default=32)
    ap.add_argument("--num_bins", type=int, default=10)
    args = ap.parse_args(argv)

    from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np

    files = sorted(f for f in os.listdir(args.data_dir)
                   if f.endswith(".pkl"))[: args.max_files]
    vals = []
    for fname in files:
        with open(op.join(args.data_dir, fname), "rb") as f:
            packet = pickle.load(f)
        h, w = packet["images"].shape[1:]
        for ev in packet["events"]:
            vol = gen_discretized_event_volume_np(ev, (2 * args.num_bins, h, w))
            vals.append(vol[vol > 0])
    v = np.concatenate(vals) if vals else np.zeros(1)
    qs = [50, 90, 95, 98, 99, 99.9, 100]
    print(f"files: {len(files)}  nonzero voxels: {v.size}")
    print(f"mean {v.mean():.4f}  std {v.std():.4f}")
    for q in qs:
        print(f"p{q}: {np.percentile(v, q):.4f}")


if __name__ == "__main__":
    main()
