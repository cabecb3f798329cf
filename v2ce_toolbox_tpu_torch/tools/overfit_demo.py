"""Overfit-to-metric training demonstration on one device.

Can the training stack learn a mapping, not just lower a loss? A fixed
batch of correlated dummy packets (events are a function of the frames,
`data/dummy_data_gen.make_correlated_packet`) is trained on with the full
loss stack, pyramid + ef + ef_splitp + compensation + GAN, until the
train BinaryMatchF1_sum_c reaches the target (the released reference
checkpoint's val level is 0.5372). `tools/overfit_demo.py` of the JAX
package does the same over a device mesh; this one runs on one device or,
with `--devices N`, data-parallel over N spawned ranks (`parallel/mesh.py`;
the largest count up to N that divides the batch), and writes the same
artifact schema (rank 0), rewritten at every eval:

    python -m v2ce_toolbox_tpu_torch.tools.overfit_demo [--steps 600] [--target 0.5] \\
        [--device cuda] [--devices 1] [--out artifacts/overfit_demo_torch.json]

Exits 0 when the target was reached, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--target", type=float, default=0.5,
                    help="train BinaryMatchF1_sum_c to reach (reference checkpoint's val "
                         "level is 0.5372)")
    ap.add_argument("--eval_every", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to train over (GPUs from cuda:0, or CPU processes)")
    ap.add_argument("--out", default=os.path.join(_REPO, "artifacts", "overfit_demo_torch.json"))
    args = ap.parse_args(argv)

    import torch

    from v2ce_toolbox_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("overfit_demo: no CUDA device; pass --device cpu")
    if dev.type == "cuda" and args.devices > torch.cuda.device_count():
        raise SystemExit(f"overfit_demo: --devices {args.devices} is more than the "
                         f"{torch.cuda.device_count()} visible GPU(s)")
    n = pmesh.data_parallel_size(args.batch_size, args.devices)
    if n == 1:
        ok = demo(None, args, dev)
    else:
        devices = [torch.device("cuda", r) for r in range(n)] if dev.type == "cuda" else ["cpu"] * n
        ok = pmesh.launch(_demo_rank, n, args=(args,), devices=devices)[0]
    raise SystemExit(0 if ok else 1)


def _demo_rank(mesh, args):
    return demo(mesh, args, mesh.device)


def demo(mesh, args, dev) -> bool:
    """The demo on `dev`, alone or as one rank of `mesh` (each rank trains
    on its block of the batch; rank 0 writes and prints). Returns whether
    the target was reached."""
    import numpy as np
    import torch

    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.parallel.mesh import shard_batch
    from v2ce_toolbox_tpu_torch.train.gan import make_discriminator
    from v2ce_toolbox_tpu_torch.train.state import create_train_state
    from v2ce_toolbox_tpu_torch.train.step import make_eval_step, make_train_step

    lead = mesh is None or mesh.is_lead
    devices = 1 if mesh is None else mesh.size
    t_start = time.time()
    h, w, seq = 32, 40, 2
    b = args.batch_size
    with tempfile.TemporaryDirectory() as td:
        generate(td, num_packets=4 * b, height=h, width=w, seed=7, correlated=True)
        ds = EventPackDataset("train", td, seq_len=seq, frame_size=(h, w),
                              include_flows=False, include_lfr=True)
        items = [ds[i] for i in range(b)]
        batch = {k: np.stack([it[k] for it in items], 0) for k in ("image_units", "voxels")}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(batch, mesh).items()}

    model = V2ce3d(ModelConfig(base_num_channels=16))
    disc = make_discriminator()
    cfg = TrainConfig(loss="pyramid+ef+ef_splitp+compensation+gan", batch_size=b, lr=1e-3,
                      lr_scheduler=None)
    state = create_train_state(model, cfg, disc=disc, mesh=mesh)
    model.to(dev)
    disc.to(dev)
    train_step = make_train_step(model, cfg, disc=disc, gan_k=1, mesh=mesh)
    eval_step = make_eval_step(model, cfg, mesh=mesh)

    trajectory = []
    reached_at = None
    f1 = best_f1 = 0.0
    if lead:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def write_artifact():
        out = {
            "task": f"overfit dummy packets, full loss stack incl. GAN, {devices} {dev.type} "
                    f"device(s)",
            "loss": cfg.loss,
            "model": "V2ce3d base16 full arch",
            "batch": [b, seq, h, w],
            "target_BinaryMatchF1_sum_c": args.target,
            "reference_checkpoint_val_level": 0.5372,
            "reached_at_step": reached_at,
            "final_BinaryMatchF1_sum_c": round(f1, 4),
            "best_BinaryMatchF1_sum_c": round(best_f1, 4),
            "trajectory": trajectory,
            "wall_s": round(time.time() - t_start, 1),
            "devices": devices,
        }
        if lead:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return out

    for step in range(1, args.steps + 1):
        state, logs = train_step(state, batch)
        if step % args.eval_every == 0 or step == 1:
            m = eval_step(state, batch)
            f1 = float(m["BinaryMatchF1_sum_c"])
            best_f1 = max(best_f1, f1)
            trajectory.append({
                "step": step,
                "loss": float(logs["loss"]),
                "BinaryMatchF1_sum_c": round(f1, 4),
                "BinaryMatch_raw": round(float(m["BinaryMatch_raw"]), 4),
            })
            if lead:
                print(f"step {step:4d}  loss {float(logs['loss']):9.4f}  "
                      f"train_BinaryMatchF1_sum_c {f1:.4f}", flush=True)
            if reached_at is None and f1 >= args.target:
                reached_at = step
            write_artifact()
            if reached_at is not None:
                break

    out = write_artifact()
    ok = reached_at is not None
    if lead:
        print(f"overfit_demo {'ok' if ok else 'DID NOT REACH TARGET'}: "
              f"BinaryMatchF1_sum_c {f1:.4f} (target {args.target}, reference val level "
              f"0.5372) at step {reached_at} in {out['wall_s']}s", flush=True)
    return ok


if __name__ == "__main__":
    main()
