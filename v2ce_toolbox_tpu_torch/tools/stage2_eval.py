"""Stage-2 sampler evaluation: for every packet in a data dir, build each
frame's GT voxel from its events, run each sampler on it, and score the
sampled stream against the GT events with the timestamp-error metric.
Prints a CSV table [avg error µs, overflow, pred/GT ratio] averaged over
the frames (the counterpart of `tools/stage2_eval.py`; the reference's
train/scripts/stage2/stage2_metrics.py:204-266).

    python -m v2ce_toolbox_tpu_torch.tools.stage2_eval --data_dir packets/ \
        --max_files 4 [--device cpu]

Frame n (in scoring order) draws from `make_draw(n, 0, device)`.
"""

from __future__ import annotations

import argparse
import os
import os.path as op
import pickle

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--max_files", type=int, default=8)
    ap.add_argument("--max_frames_per_file", type=int, default=4)
    ap.add_argument("--search_range", type=int, default=0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--fix_10x_timestamps", action="store_true",
                    help="apply the reference's 10x timestamp data-bug correction "
                         "(stage2_metrics.py:112-116)")
    ap.add_argument("--samplers", nargs="*", default=["ldati", "random", "even", "slope"])
    ap.add_argument("--recorder_dir", default=None,
                    help="evaluate on model-predicted voxels dumped as pkl files with "
                         "'pred_voxels' (B, L, H, W, 20), matched to the val split of "
                         "--data_dir in its deterministic order")
    ap.add_argument("-o", "--out_csv", default=None)
    ap.add_argument("--device", default="cuda", help="where the samplers run")
    return ap


def _load(path: str, fix_10x: bool) -> dict:
    with open(path, "rb") as f:
        packet = pickle.load(f)
    if fix_10x:
        for ev in packet["events"]:
            ev["timestamp"] = ev["timestamp"] // 10
    return packet


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
    from v2ce_toolbox_tpu_torch.eval.stage2_metrics import evaluate_samplers_on_frame
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw

    agg = {name: np.zeros(3) for name in args.samplers}
    n = 0

    def score_frame(ev, voxel):
        nonlocal n
        ev = ev.copy()
        if len(ev):                                  # the metric works in frame time
            ev["timestamp"] -= ev["timestamp"].min()
        scores = evaluate_samplers_on_frame(
            ev, voxel, samplers=args.samplers, fps=args.fps,
            search_range=args.search_range, draws=lambda name: make_draw(n, 0, args.device),
            device=args.device)
        for name, (d, o, r) in scores.items():
            agg[name] += np.array([d, o, r])
        n += 1

    if args.recorder_dir:
        from v2ce_toolbox_tpu_torch.data.event_pack_dataset import split_paths

        val_paths = split_paths(args.data_dir)["val"]
        recs = sorted(f for f in os.listdir(args.recorder_dir)
                      if f.endswith(".pkl"))[:args.max_files]
        path_idx = 0
        for rname in recs:
            with open(op.join(args.recorder_dir, rname), "rb") as f:
                pred = pickle.load(f)["pred_voxels"]            # (B, L, H, W, 20)
            for b in range(pred.shape[0]):
                if path_idx >= len(val_paths):
                    break
                packet = _load(val_paths[path_idx], args.fix_10x_timestamps)
                path_idx += 1
                for i in range(min(pred.shape[1], len(packet["events"]),
                                   args.max_frames_per_file)):
                    v = np.moveaxis(pred[b, i], -1, 0).reshape(2, 10, *pred.shape[2:4])
                    score_frame(packet["events"][i], v)
            print(f"{rname}: {n} frames scored", flush=True)
    else:
        files = sorted(f for f in os.listdir(args.data_dir)
                       if f.endswith(".pkl"))[:args.max_files]
        for fname in files:
            packet = _load(op.join(args.data_dir, fname), args.fix_10x_timestamps)
            h, w = packet["images"].shape[1:]
            for ev in packet["events"][:args.max_frames_per_file]:
                vol = gen_discretized_event_volume_np(ev, (20, h, w))
                score_frame(ev, vol.reshape(2, 10, h, w))
            print(f"{fname}: {n} frames scored", flush=True)

    rows = ["sampler,avg_error_us,overflow,pred_gt_ratio"]
    for name in args.samplers:
        d, o, r = agg[name] / max(n, 1)
        rows.append(f"{name},{d:.2f},{o:.2f},{r:.4f}")
    table = "\n".join(rows)
    print(table)
    if args.out_csv:
        with open(args.out_csv, "w") as f:
            f.write(table + "\n")
    return table


if __name__ == "__main__":
    main()
