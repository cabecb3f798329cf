"""V2CE stage-1 training on one GPU.

    python -m v2ce_toolbox_tpu_torch.data.dummy_data_gen --data_dir dummy_data
    python -m v2ce_toolbox_tpu_torch.train.main --data_dir dummy_data \\
        --max_epochs 1 --batch_size 2 [--device cpu]

`train_main.py`'s flags and defaults (V2ce3d base 32 with 4 encoders,
16-frame sequences, batch 4, the loss stack pyramid gan ef ef_splitp
compensation with gan_k 3 and the 2D PatchGAN), plus `--device` (default
cuda; without a card it refuses to start unless `--device cpu` is
given). It writes `train_main.py`'s `metrics.jsonl` lines (the train lines
also carry `global_step`, the state's step after the update),
`checkpoints/best-epoch=N` (monitor BinaryMatchF1_sum_c, max) and
`checkpoints/last` after every eval, `previews/epoch<N>.png` and, with
`--record_predictions`, `recorder/val-e<N>-b<i>.pkl`. `--load_dir` resumes
the whole state (model, BN statistics, spectral-norm vectors,
discriminator, both optimizers, step) from a checkpoint directory or file.
"""

import argparse
import json
import logging
import os
import os.path as op
import pickle
import time

logger = logging.getLogger("train")

MULTI_DEVICE = ("is not ported: the port trains on one device; data-parallel "
                "training (DDP with SyncBatchNorm) is ROADMAP queue 1 item 6")


def SBool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group("Basic Training Control")
    g.add_argument("--batch_size", default=4, type=int)
    g.add_argument("--num_workers", default=4, type=int)
    g.add_argument("--seed", default=1234, type=int)
    g.add_argument("--weight_decay", default=1e-5, type=float)
    g.add_argument("--test_only", type=SBool, default=False, nargs="?", const=True)
    g.add_argument("--max_epochs", default=100, type=int)
    g.add_argument("--devices", default=None, type=int,
                   help="number of devices; only 1 is ported")
    g.add_argument("--coordinator", default=None, type=str,
                   help="multi-host coordinator address host:port (not ported)")
    g.add_argument("--num_processes", default=1, type=int,
                   help="total number of host processes in the job (only 1 is ported)")
    g.add_argument("--process_id", default=0, type=int,
                   help="this host's rank in [0, num_processes)")
    g.add_argument("--device", default="cuda", type=str,
                   help="torch device to train on (cuda, cuda:N or cpu)")

    g = p.add_argument_group("LR and Scheduler")
    g.add_argument("--lr", default=1e-3, type=float)
    g.add_argument("--lr_scheduler", choices=["step", "cosine"], type=str)
    g.add_argument("--lr_decay_steps", default=10, type=int)
    g.add_argument("--lr_decay_rate", default=0.5, type=float)
    g.add_argument("--lr_decay_min_lr", default=1e-6, type=float)

    g = p.add_argument_group("Restart Control")
    g.add_argument("--load_dir", default=None, type=str)
    g.add_argument("--load_best", action="store_true")

    g = p.add_argument_group("Logs and Training Info")
    g.add_argument("--log_dir", default="./logs", type=str)
    g.add_argument("--exp_name", default=None, type=str)
    g.add_argument("--logging_level", default="INFO", type=str)
    g.add_argument("--log_frequency", default=8, type=int)

    g = p.add_argument_group("Loss & Metrics Info")
    g.add_argument("--loss", default=["pyramid", "gan", "ef", "ef_splitp",
                                      "compensation"], nargs="*")
    g.add_argument("--add_base_loss", type=SBool, default=False, nargs="?", const=True)
    g.add_argument("--ef_type", default="c+cl", choices=("only_c", "cl", "c+cl"))
    g.add_argument("--metrics", type=str, nargs="*",
                   default=["L1", "BinaryMatch", "BinaryMatchF1", "PoolMSE"])
    g.add_argument("--gan_k", default=3, type=int)
    g.add_argument("--gan_3d_conv", type=SBool, default=False, nargs="?", const=True)

    g = p.add_argument_group("Model & Data")
    g.add_argument("--model_name", default="v2ce_3d", type=str)
    g.add_argument("--base_num_channels", default=32, type=int)
    g.add_argument("--num_encoders", default=4, type=int)
    g.add_argument("--dataset", default="event_pack_dataset", type=str)
    g.add_argument("--data_dir", default="dummy_data", type=str)
    g.add_argument("--seq_len", default=16, type=int)
    g.add_argument("--partial_dataset", default=1.0, type=float)
    g.add_argument("--random_flip", type=SBool, default=False, nargs="?", const=True)
    g.add_argument("--max_steps_per_epoch", default=0, type=int,
                   help="truncate epochs (0 = full epoch)")
    g.add_argument("--dump_previews", type=SBool, default=True, nargs="?", const=True,
                   help="save input/GT/pred event-frame preview grids each eval")
    g.add_argument("--record_predictions", default=0, type=int,
                   help="dump this many val batches (pred + GT voxels) to "
                        "<workdir>/recorder each eval (stage-2 eval input)")
    return p


def check_args(args) -> None:
    """Refuse what the port does not run, before anything is built."""
    if args.devices not in (None, 1):
        raise NotImplementedError(f"--devices {args.devices} {MULTI_DEVICE}")
    if args.num_processes > 1 or args.coordinator:
        raise NotImplementedError(f"--num_processes/--coordinator {MULTI_DEVICE}")
    if args.model_name != "v2ce_3d":
        raise NotImplementedError(
            f"--model_name {args.model_name!r}: the JAX trainer builds V2ce3d whatever "
            "--model_name names (train_main.py:82,167), so the port trains only v2ce_3d and "
            "refuses other names rather than train a model the flag does not name")
    if args.dataset != "event_pack_dataset":
        raise NotImplementedError(f"--dataset {args.dataset!r}: only event_pack_dataset is "
                                  "ported")


def write_preview(path, pred, batch):
    """Input, GT and pred event frames of the batch's first item, every
    quarter of its frames, and its first log-frame residual."""
    import numpy as np

    from v2ce_toolbox_tpu_torch.tools.vis_tools import batch_show, event_frame_rgb

    pv = pred[0].float().cpu().numpy()                   # (L, H, W, 20)
    gv = batch["voxels"][0].cpu().numpy()
    frames = batch["image_units"][0].cpu().numpy()      # (L, H, W, 2)
    imgs, titles = [], []
    for i in range(0, pv.shape[0], max(pv.shape[0] // 4, 1)):
        def ref_layout(a):
            return np.moveaxis(a[i], -1, 0).reshape(2, 10, *a.shape[1:3])

        # denormalized input frame
        imgs.append(np.clip(frames[i, :, :, 0] * 0.165 + 0.153, 0, 1))
        imgs += [event_frame_rgb(ref_layout(gv)), event_frame_rgb(ref_layout(pv))]
        titles += [f"input f{i}", f"gt f{i}", f"pred f{i}"]
    if "lfr" in batch:
        lfr = batch["lfr"][0].cpu().numpy()
        rng = np.ptp(lfr[0]) or 1.0
        imgs.append((lfr[0, :, :, 0] - lfr[0].min()) / rng)
        titles.append("lfr f0")
    os.makedirs(op.dirname(path), exist_ok=True)
    batch_show(imgs, cols=3, titles=titles, save_path=path)


def main(argv=None):
    """Train (or, with --test_only, evaluate). Returns {'work_dir', 'state',
    'step_s': wall seconds of each train step, synchronised, 'evals':
    each eval's aggregated metrics}."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper()))
    check_args(args)

    import torch

    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.data.loader import device_prefetch, iterate_batches
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.train.gan import make_discriminator
    from v2ce_toolbox_tpu_torch.train.state import create_train_state
    from v2ce_toolbox_tpu_torch.train.step import make_eval_step, make_train_step
    from v2ce_toolbox_tpu_torch.utils.checkpoint import (
        best_or_last,
        load_checkpoint,
        save_checkpoint,
    )

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train.main: no CUDA device; pass --device cpu to train on the CPU")
    cuda = dev.type == "cuda"
    torch.manual_seed(args.seed)

    exp = args.exp_name or time.strftime("%Y%m%d-%H%M%S")
    work_dir = op.join(args.log_dir, exp)
    ckpt_dir = op.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        lr_scheduler=args.lr_scheduler, lr_decay_steps=args.lr_decay_steps,
        lr_decay_rate=args.lr_decay_rate, lr_decay_min_lr=args.lr_decay_min_lr,
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        seed=args.seed, loss="+".join(args.loss),
        ef_type=args.ef_type, add_base_loss=args.add_base_loss,
    )

    train_ds = EventPackDataset("train", args.data_dir, seq_len=args.seq_len,
                                partial_dataset=args.partial_dataset,
                                random_flip=args.random_flip)
    val_ds = EventPackDataset("val", args.data_dir, seq_len=args.seq_len)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)

    model = V2ce3d(ModelConfig(base_num_channels=args.base_num_channels,
                               num_encoders=args.num_encoders))
    disc = make_discriminator(args.gan_3d_conv) if "gan" in args.loss else None
    state = create_train_state(model, cfg, disc=disc, seed=args.seed)
    model.to(dev)
    if disc is not None:
        disc.to(dev)

    if args.load_dir:
        ckpt = best_or_last(args.load_dir, prefer_best=args.load_best) or args.load_dir
        state = load_checkpoint(ckpt, target=state)
        logger.info("resumed from checkpoint %s at step %d", ckpt, state.step)

    train_step = make_train_step(model, cfg, disc=disc, gan_k=args.gan_k,
                                 use_3d_disc=args.gan_3d_conv, steps_per_epoch=steps_per_epoch)
    eval_step = make_eval_step(model, cfg, metric_names=[m.lower() for m in args.metrics])

    best_f1 = -1.0
    recorder_dir = op.join(work_dir, "recorder")
    step_s, evals = [], []

    def predict(batch):
        with torch.no_grad():
            return state.model.eval()(batch["image_units"])

    def run_eval(epoch):
        nonlocal best_f1
        agg, n_b = {}, 0
        batches = iterate_batches(val_ds, args.batch_size, shuffle=False,
                                  num_workers=args.num_workers)
        for batch in device_prefetch(batches, dev):
            m = eval_step(state, batch)
            if n_b < args.record_predictions:
                os.makedirs(recorder_dir, exist_ok=True)
                with open(op.join(recorder_dir, f"val-e{epoch}-b{n_b}.pkl"), "wb") as f:
                    pickle.dump({"pred_voxels": predict(batch).cpu().numpy(),
                                 "gt_voxels": batch["voxels"].cpu().numpy(),
                                 "epoch": epoch}, f)
            if args.dump_previews and n_b == 0:
                write_preview(op.join(work_dir, "previews", f"epoch{epoch}.png"),
                              predict(batch), batch)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n_b += 1
            if args.max_steps_per_epoch and n_b >= args.max_steps_per_epoch:
                break
        agg = {k: v / max(n_b, 1) for k, v in agg.items()}
        agg["epoch"] = epoch
        metrics_log.write(json.dumps({"eval": agg}) + "\n")
        metrics_log.flush()
        logger.info("eval epoch %d: %s", epoch, {k: round(v, 4) for k, v in agg.items()})
        evals.append(agg)
        f1 = agg.get("BinaryMatchF1_sum_c", 0.0)
        if f1 > best_f1:
            best_f1 = f1
            save_checkpoint(op.join(ckpt_dir, f"best-epoch={epoch}"), state)
        save_checkpoint(op.join(ckpt_dir, "last"), state)
        return agg

    with open(op.join(work_dir, "metrics.jsonl"), "a") as metrics_log:
        if args.test_only:
            run_eval(-1)
            return {"work_dir": work_dir, "state": state, "step_s": step_s, "evals": evals}
        for epoch in range(args.max_epochs):
            t0 = time.time()
            batches = iterate_batches(train_ds, args.batch_size, shuffle=True,
                                      seed=args.seed + epoch, num_workers=args.num_workers)
            for i, batch in enumerate(device_prefetch(batches, dev)):
                ts = time.perf_counter()
                state, logs = train_step(state, batch)
                if cuda:
                    torch.cuda.synchronize(dev)
                step_s.append(time.perf_counter() - ts)
                if i % args.log_frequency == 0:
                    line = {k: float(v) for k, v in logs.items()}
                    line.update(epoch=epoch, step=i, global_step=state.step)
                    metrics_log.write(json.dumps({"train": line}) + "\n")
                    metrics_log.flush()
                    logger.info("epoch %d step %d loss %.4f", epoch, i, line["loss"])
                if args.max_steps_per_epoch and i + 1 >= args.max_steps_per_epoch:
                    break
            logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
            run_eval(epoch)
    return {"work_dir": work_dir, "state": state, "step_s": step_s, "evals": evals}


if __name__ == "__main__":
    main()
