"""Stage-1 speed and size: V2ce3d's parameter count, its FLOPs a forward
and its steady-state forward latency (the counterpart of
`tools/speed_test.py`; the reference's train/scripts/tools/speed_test.py).

    python -m v2ce_toolbox_tpu_torch.tools.speed_test [--height 512 --width 512] \
        [--seq_len 16] [--iters 20] [--bf16] [--device cuda]

The model is `ModelConfig()` on `init_weights(model, 0)`, in bf16 under
--bf16. Parameters are the trained ones (the spectral norms' u and v and
the BN statistics are not). FLOPs are counted from shapes: 2 x (Cin /
groups) x prod(kernel) x Cout x output positions, summed over every conv
one forward calls (V2ce3d has no transposed conv: its decoders upsample
by nearest). The latency is CUDA events around --iters forwards after a
warm one (the host clock after a sync on the CPU), on the JAX tool's
input, `RandomState(0)` uniforms of (1, seq_len, H, W, 2).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

CONVS = (torch.conv1d, torch.conv2d, torch.conv3d)


class ConvFlops(TorchFunctionMode):
    """Counts the multiply-adds (x2) of every torch conv called under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in CONVS:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.flops += 2 * out.numel() * math.prod(w.shape[1:])
        return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--seq_len", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def param_count(model: torch.nn.Module) -> int:
    """The trained parameters' elements: the JAX model's `params`."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def forward_flops(model: torch.nn.Module, x: torch.Tensor) -> tuple:
    """(model(x), the FLOPs of its convs) of one eval forward."""
    counter = ConvFlops()
    with torch.no_grad(), counter:
        y = model(x)
    return y, counter.flops


def counts(cfg, shape) -> tuple:
    """(parameters, conv FLOPs a forward) of V2ce3d(cfg) on a (B, L, H, W,
    2) input, from shapes alone on the meta device."""
    from v2ce_toolbox_tpu_torch.models import V2ce3d

    with torch.device("meta"):
        model = V2ce3d(cfg).eval()
        x = torch.empty(shape)
    return param_count(model), forward_flops(model, x)[1]


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from v2ce_toolbox_tpu_torch.config import ModelConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    dev = torch.device(args.device)
    cfg = ModelConfig(compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    model = V2ce3d(cfg)
    init_weights(model, 0)
    model = model.to(dev).eval()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(1, args.seq_len, args.height, args.width, 2)
                         .astype(np.float32)).to(dev)
    n_params = param_count(model)
    print(f"params: {n_params / 1e6:.2f} M")
    _, flops = forward_flops(model, x)                  # counted and warm
    print(f"analytical flops/forward: {flops / 1e9:.1f} G")

    cuda = dev.type == "cuda"
    with torch.no_grad():
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(args.iters):
                model(x)
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) / 1e3 / args.iters
        else:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(x)
            dt = (time.perf_counter() - t0) / args.iters
    print(f"avg forward latency: {dt * 1000:.2f} ms ({args.seq_len / dt:.1f} frames/s, "
          f"{flops / dt / 1e12:.2f} TFLOP/s effective)")
    return dict(params=n_params, flops=flops, ms=dt * 1e3, frames_per_s=args.seq_len / dt,
                tflops_per_s=flops / dt / 1e12, dtype="bfloat16" if args.bf16 else "float32",
                shape=tuple(x.shape), device=str(dev))


if __name__ == "__main__":
    main()
