"""Overfit-to-metric training demonstration on one device.

Can the training stack learn a mapping, not just lower a loss? A fixed
batch of correlated dummy packets (events are a function of the frames,
`data/dummy_data_gen.make_correlated_packet`) is trained on with the full
loss stack, pyramid + ef + ef_splitp + compensation + GAN, until the
train BinaryMatchF1_sum_c reaches the target (the released reference
checkpoint's val level is 0.5372). `tools/overfit_demo.py` of the JAX
package does the same over a device mesh; this one runs on one device,
with the batch that mesh held, and writes the same artifact schema,
rewritten at every eval:

    python -m v2ce_toolbox_tpu_torch.tools.overfit_demo [--steps 600] [--target 0.5] \\
        [--device cuda] [--out artifacts/overfit_demo_torch.json]

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
    ap.add_argument("--out", default=os.path.join(_REPO, "artifacts", "overfit_demo_torch.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.train.gan import make_discriminator
    from v2ce_toolbox_tpu_torch.train.state import create_train_state
    from v2ce_toolbox_tpu_torch.train.step import make_eval_step, make_train_step

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("overfit_demo: no CUDA device; pass --device cpu")
    t_start = time.time()
    h, w, seq = 32, 40, 2
    b = args.batch_size
    with tempfile.TemporaryDirectory() as td:
        generate(td, num_packets=4 * b, height=h, width=w, seed=7, correlated=True)
        ds = EventPackDataset("train", td, seq_len=seq, frame_size=(h, w),
                              include_flows=False, include_lfr=True)
        items = [ds[i] for i in range(b)]
        batch = {k: torch.from_numpy(np.stack([it[k] for it in items], 0)).to(dev)
                 for k in ("image_units", "voxels")}

    model = V2ce3d(ModelConfig(base_num_channels=16))
    disc = make_discriminator()
    cfg = TrainConfig(loss="pyramid+ef+ef_splitp+compensation+gan", batch_size=b, lr=1e-3,
                      lr_scheduler=None)
    state = create_train_state(model, cfg, disc=disc)
    model.to(dev)
    disc.to(dev)
    train_step = make_train_step(model, cfg, disc=disc, gan_k=1)
    eval_step = make_eval_step(model, cfg)

    trajectory = []
    reached_at = None
    f1 = best_f1 = 0.0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def write_artifact():
        out = {
            "task": f"overfit dummy packets, full loss stack incl. GAN, one {dev.type} device",
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
            "devices": 1,
        }
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
            print(f"step {step:4d}  loss {float(logs['loss']):9.4f}  "
                  f"train_BinaryMatchF1_sum_c {f1:.4f}", flush=True)
            if reached_at is None and f1 >= args.target:
                reached_at = step
            write_artifact()
            if reached_at is not None:
                break

    out = write_artifact()
    ok = reached_at is not None
    print(f"overfit_demo {'ok' if ok else 'DID NOT REACH TARGET'}: "
          f"BinaryMatchF1_sum_c {f1:.4f} (target {args.target}, reference val level 0.5372) "
          f"at step {reached_at} in {out['wall_s']}s", flush=True)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
