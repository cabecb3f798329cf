"""The stage-2 samplers side by side (the counterpart of
`tools/vis_stage2.py`, the script form of the reference's
vis_stage2.ipynb): a synthetic moving-edge stream -> its GT voxel -> LDATI,
the random and even baselines and pure slope -> per-sampler counts, a
timestamp histogram of every stream and an x-y-t scatter of each.

    python -m v2ce_toolbox_tpu_torch.tools.vis_stage2 [-o vis_stage2] [--device cuda] [--seed 0]

The samplers run on --device, each drawing from `make_draw(seed, 0,
device)`; the plots need matplotlib, and without it `main` prints the
counts and exits with an error that says so.
"""

from __future__ import annotations

import argparse
import os
import os.path as op
from typing import Dict

import numpy as np

H, W = 64, 80


def synth_events(n: int = 4000, h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """A moving-edge stream whose events grow denser later in the frame (a
    quadratic time density, what the slope sampler models): the JAX
    tool's, draw for draw."""
    from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE

    rng = np.random.RandomState(seed)
    ev = np.zeros(n, EVENT_DTYPE)
    u = rng.rand(n)
    ev["timestamp"] = np.sort((u ** 0.5 * 33333).astype(np.int64))
    edge_x = (ev["timestamp"] / 33333 * w * 0.8).astype(int)
    ev["x"] = np.clip(edge_x + rng.randint(-2, 3, n), 0, w - 1)
    ev["y"] = rng.randint(0, h, n)
    ev["polarity"] = rng.randint(0, 2, n)
    return ev


def sampler_streams(device="cuda", seed: int = 0, draw=None) -> Dict[str, np.ndarray]:
    """{name: time-sorted recarray}: the synthetic GT stream, and each
    sampler's stream from its GT voxel (1, 2, 10, H, W) on `device`, every
    sampler drawing from `draw` (default `make_draw(seed, 0, device)`)."""
    from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_voxel_statistical
    from v2ce_toolbox_tpu_torch.ops.samplers import (
        sample_voxel_baseline,
        sample_voxel_pure_slope,
    )

    gt = synth_events()
    voxel = gen_discretized_event_volume_np(gt, (20, H, W)).reshape(1, 2, 10, H, W)
    draw = draw or make_draw(seed, 0, device)
    return {"gt": gt,
            "ldati": sample_voxel_statistical(voxel, draw=draw, device=device)[0],
            "random": sample_voxel_baseline(voxel, random=True, draw=draw, device=device)[0],
            "even": sample_voxel_baseline(voxel, even=True, draw=draw, device=device)[0],
            "slope": sample_voxel_pure_slope(voxel, draw=draw, device=device)[0]}


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--out_dir", default="vis_stage2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    streams = sampler_streams(args.device, args.seed)
    for name, s in streams.items():
        print(f"{name}: {len(s)} events")
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"vis_stage2: the plots need matplotlib, which is not installed "
                         f"({e}); nothing was plotted") from e

    from v2ce_toolbox_tpu_torch.tools.vis_tools import plot_raw_events_xyt

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(args.out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, s in streams.items():
        ax.hist(s["timestamp"], bins=60, histtype="step", label=name)
    ax.set_xlabel("t (µs)")
    ax.set_ylabel("events")
    ax.legend()
    fig.savefig(op.join(args.out_dir, "timestamp_hist.png"), dpi=120)
    plt.close(fig)
    for name, s in streams.items():
        plot_raw_events_xyt(s, save_path=op.join(args.out_dir, f"xyt_{name}.png"))
    print(f"wrote plots to {args.out_dir}")
    return {name: len(s) for name, s in streams.items()}


if __name__ == "__main__":
    main()
