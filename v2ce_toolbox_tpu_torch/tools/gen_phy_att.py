"""Regenerate the physical_att field of the packet files in a directory.

    python -m v2ce_toolbox_tpu_torch.tools.gen_phy_att --data_dir packets/ [--advanced]

The packets are rewritten in place, each with the physical attention of
its frame pairs and events (`utils/physical_att`), by a thread pool;
progress and the count are printed as `tools/gen_phy_att.py` prints them.
The metric is numpy on the host, as in the JAX package: no device work.
"""

import argparse
import concurrent.futures
import os
import os.path as op
import pickle

import numpy as np


def process_one(path: str, pool_size: int, advanced: bool, ceiling: float) -> str:
    from v2ce_toolbox_tpu_torch.utils.physical_att import physical_attention_batch_generation

    with open(path, "rb") as f:
        packet = pickle.load(f)
    frames = np.stack([packet["images"][:-1], packet["images"][1:]], axis=1)
    packet["physical_att"] = physical_attention_batch_generation(
        packet["events"], frames.astype(np.float64), pool_size, advanced=advanced,
        ceiling=ceiling)
    with open(path, "wb") as f:
        pickle.dump(packet, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--pool_size", type=int, default=8)
    ap.add_argument("--advanced", action="store_true")
    ap.add_argument("--ceiling", type=float, default=5)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    paths = sorted(op.join(args.data_dir, f)
                   for f in os.listdir(args.data_dir) if f.endswith(".pkl"))
    with concurrent.futures.ThreadPoolExecutor(args.workers) as pool:
        for i, _ in enumerate(pool.map(
                lambda p: process_one(p, args.pool_size, args.advanced, args.ceiling), paths)):
            if i % 50 == 0:
                print(f"{i+1}/{len(paths)}", flush=True)
    print(f"rewrote physical_att in {len(paths)} packets")


if __name__ == "__main__":
    main()
