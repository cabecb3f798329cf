"""Score an external simulator's event stream (ESIM, v2e, ...) against GT
packets with the stage-1 voxel metrics.

    python -m v2ce_toolbox_tpu_torch.tools.baseline_metric --pred events.npz --data_dir packets/

The simulator stream is cut into each packet's frame intervals, voxelized
like the GT and scored with BinaryMatch / BinaryMatchF1 / PoolMSE; the
means over the packets are printed (`tools/baseline_metric.py`'s output).
"""

import argparse
import os
import os.path as op
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", required=True, help=".npz with an 'event_stream' structured array")
    ap.add_argument("--data_dir", required=True, help="GT packet dir (16-frame pkl packets)")
    ap.add_argument("--max_files", type=int, default=8)
    ap.add_argument("--num_bins", type=int, default=10)
    args = ap.parse_args(argv)

    from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
    from v2ce_toolbox_tpu_torch.eval.baseline_metrics import score_stream_against_gt

    pred = np.load(args.pred)["event_stream"]
    files = sorted(f for f in os.listdir(args.data_dir) if f.endswith(".pkl"))[: args.max_files]
    agg, n = {}, 0
    for fname in files:
        with open(op.join(args.data_dir, fname), "rb") as f:
            packet = pickle.load(f)
        h, w = packet["images"].shape[1:]
        gt = np.stack([gen_discretized_event_volume_np(ev, (2 * args.num_bins, h, w))
                       for ev in packet["events"]])
        ts = packet["timestamps"].astype(np.int64)
        sel = (pred["timestamp"] >= ts[0]) & (pred["timestamp"] < ts[-1])
        for k, v in score_stream_against_gt(pred[sel], gt, timestamps=ts).items():
            agg[k] = agg.get(k, 0.0) + v
        n += 1
    for k in sorted(agg):
        print(f"{k}: {agg[k] / max(n, 1):.4f}")
    return {k: v / max(n, 1) for k, v in agg.items()}


if __name__ == "__main__":
    main()
