"""LDATI stage-2 speed: ms a frame, frames/s and events/s of the port's
sampler on random voxels (the counterpart of `tools/perf_test_stage2.py`).

    python -m v2ce_toolbox_tpu_torch.tools.perf_test_stage2 [--batch 10] [--iters 10] \
        [--height 260 --width 346] [--sparsity 0.1] [--strategy slope|random|none] \
        [--device cuda] [--seed 0]

The voxels are the JAX tool's (`RandomState(42)`: values U[0, 2) where a
second uniform falls under --sparsity). `sample_events` runs once warm,
then --iters times, call i drawing from `make_draw(seed, i, device)`, timed
by CUDA events around the loop (the host clock after a sync on the CPU);
events are each call's `count` summed over its frames. The JAX tool adds
1e-9 x the running event total to the voxels each iteration, to keep XLA
from hoisting the call out of its loop, and so samples shifted voxels
after the first; here every call samples the same voxels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=10, help="frames a call (the reference's B=10)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--height", type=int, default=260)
    ap.add_argument("--width", type=int, default=346)
    ap.add_argument("--sparsity", type=float, default=0.1)
    ap.add_argument("--strategy", default="slope", choices=["slope", "random", "none"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def voxels(batch: int, height: int, width: int, sparsity: float) -> np.ndarray:
    """The JAX tool's (batch, 2, 10, H, W) f32 voxels."""
    rng = np.random.RandomState(42)
    shape = (batch, 2, 10, height, width)
    return (rng.rand(*shape) * 2 * (rng.rand(*shape) < sparsity)).astype(np.float32)


def report_line(ms_per_frame: float, frames_per_s: float, events_per_s: float,
                events_per_frame: float) -> str:
    """The JAX tool's printed line."""
    return (f"{ms_per_frame:.3f} ms/frame  ({frames_per_s:.1f} frames/s, "
            f"{events_per_s / 1e6:.2f} M events/s, {events_per_frame:.0f} events/frame)")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_events

    dev = torch.device(args.device)
    y = torch.from_numpy(voxels(args.batch, args.height, args.width, args.sparsity)).to(dev)
    cfg = SamplerConfig(additional_events_strategy=args.strategy)
    cuda = dev.type == "cuda"

    def call(i):
        return sample_events(y, make_draw(args.seed, i, dev), cfg).count.sum()

    call(0)                                             # warm
    counts = []
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for i in range(args.iters):
            counts.append(call(i))
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / args.iters
    else:
        t0 = time.perf_counter()
        for i in range(args.iters):
            counts.append(call(i))
        dt = (time.perf_counter() - t0) / args.iters
    events = float(torch.stack(counts).sum()) / args.iters
    out = dict(ms_per_frame=dt * 1e3 / args.batch, frames_per_s=args.batch / dt,
               events_per_s=events / dt, events_per_frame=events / args.batch,
               events_per_call=events, device=str(dev), strategy=args.strategy)
    print(report_line(out["ms_per_frame"], out["frames_per_s"], out["events_per_s"],
                      out["events_per_frame"]))
    return out


if __name__ == "__main__":
    main()
