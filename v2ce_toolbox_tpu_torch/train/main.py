"""V2CE stage-1 training, on one device or data-parallel over several.

    python -m v2ce_toolbox_tpu_torch.data.dummy_data_gen --data_dir dummy_data
    python -m v2ce_toolbox_tpu_torch.train.main --data_dir dummy_data \\
        --max_epochs 1 --batch_size 2 [--device cpu] [--devices N]

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

Data parallelism, one process a rank (`parallel/mesh.py`), as
`train_main.py` runs over a device mesh: the global batch `--batch_size`
splits over n ranks, n the largest count up to the available devices
that divides it (`--devices`, else every visible GPU; on the CPU
`--devices`, else 1), with BatchNorm over the global batch and gradients
averaged over the ranks: the same step as one device on the whole batch.
Worlds:
  * `--devices N` on one host: N ranks spawned here (NCCL, one GPU each;
    gloo with `--device cpu`);
  * under torchrun (`RANK`, `WORLD_SIZE`, `LOCAL_RANK` set): each process
    is a rank, on `cuda:LOCAL_RANK`;
  * `--coordinator host:port --num_processes P --process_id i`: a TCP
    rendezvous of P processes started by hand, one rank each.
Rank 0 alone writes `metrics.jsonl`, the checkpoints, the previews and the
recorder (whose pickles hold the whole global batch); every rank loads
`--load_dir`.
"""

import argparse
import json
import logging
import os
import os.path as op
import pickle
import time

logger = logging.getLogger("train")


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
                   help="devices to train over, one spawned rank each (default: every "
                        "visible GPU; 1 on the CPU), cut to the largest count that divides "
                        "--batch_size")
    g.add_argument("--coordinator", default=None, type=str,
                   help="rendezvous address host:port of a multi-process run")
    g.add_argument("--num_processes", default=1, type=int,
                   help="total number of processes (ranks) in the job")
    g.add_argument("--process_id", default=0, type=int,
                   help="this process's rank in [0, num_processes)")
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
    if args.devices is not None and args.devices < 1:
        raise ValueError(f"--devices {args.devices}: at least 1")
    if args.num_processes < 1:
        raise ValueError(f"--num_processes {args.num_processes}: at least 1")
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError(f"--num_processes {args.num_processes} needs --coordinator host:port, "
                         "the rendezvous of the processes")
    if not 0 <= args.process_id < args.num_processes:
        raise ValueError(f"--process_id {args.process_id} is not in [0, --num_processes "
                         f"{args.num_processes})")
    if args.coordinator and args.devices not in (None, 1):
        raise ValueError("--devices spawns the ranks of one host; with --coordinator each "
                         "process is one rank")
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


def _world_from_env(args):
    """(rendezvous, processes, this rank, local rank) of a world started
    outside this process (--coordinator, or torchrun's variables), or
    None."""
    if args.coordinator or args.num_processes > 1:
        return (args.coordinator, args.num_processes, args.process_id,
                int(os.environ.get("LOCAL_RANK", 0)))
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", 0)))
    return None


def _available(args, dev, torch) -> int:
    """Devices a spawned world may take: --devices, else every visible GPU
    for `--device cuda` (1 for a named card or the CPU)."""
    named = dev.type == "cuda" and dev.index is not None
    if args.devices is None:
        return torch.cuda.device_count() if dev.type == "cuda" and not named else 1
    if args.devices > 1 and named:
        raise ValueError(f"--devices {args.devices} with --device {dev}: name no card to "
                         "train over several")
    if dev.type == "cuda" and args.devices > torch.cuda.device_count():
        raise ValueError(f"--devices {args.devices} is more than the "
                         f"{torch.cuda.device_count()} visible GPU(s)")
    return args.devices


def main(argv=None):
    """Train (or, with --test_only, evaluate). Returns {'work_dir', 'state',
    'step_s': wall seconds of each train step, synchronised, 'evals':
    each eval's aggregated metrics}; over spawned ranks, rank 0's, with
    'state' None and 'ranks' each rank's."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.logging_level.upper()))
    check_args(args)

    import torch

    from v2ce_toolbox_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train.main: no CUDA device; pass --device cpu to train on the CPU")
    world = _world_from_env(args)
    if world is not None:
        url, n, rank, local = world
        if args.batch_size % n:
            raise ValueError(f"--batch_size {args.batch_size} does not split over {n} processes")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local)
        mesh = pmesh.init_distributed(url, n, rank, device=dev)
        try:
            return train(args, mesh.device, mesh)
        finally:
            torch.distributed.destroy_process_group()
    n = pmesh.data_parallel_size(args.batch_size, _available(args, dev, torch))
    if n == 1:
        return train(args, dev, None)
    logger.info("data-parallel over %d ranks, global batch %d", n, args.batch_size)
    devices = [torch.device("cuda", r) for r in range(n)] if dev.type == "cuda" else ["cpu"] * n
    ranks = pmesh.launch(_train_rank, n, args=(args,), devices=devices)
    return dict(ranks[0], state=None, ranks=ranks)


def _train_rank(mesh, args):
    """One spawned rank of `main`: its result without the state."""
    out = train(args, mesh.device, mesh)
    out.pop("state")
    return out


def train(args, dev, mesh):
    """The run of `main` on device `dev`: alone (mesh None) or as one rank of
    a data-parallel `mesh`."""
    import torch

    from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.data.loader import device_prefetch, iterate_batches
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.parallel.mesh import gather_to_lead
    from v2ce_toolbox_tpu_torch.train.gan import make_discriminator
    from v2ce_toolbox_tpu_torch.train.state import create_train_state
    from v2ce_toolbox_tpu_torch.train.step import make_eval_step, make_train_step
    from v2ce_toolbox_tpu_torch.utils.checkpoint import (
        best_or_last,
        load_checkpoint,
        save_checkpoint,
    )

    cuda = dev.type == "cuda"
    lead = mesh is None or mesh.is_lead
    torch.manual_seed(args.seed)

    exp = args.exp_name or time.strftime("%Y%m%d-%H%M%S")
    work_dir = op.join(args.log_dir, exp)
    ckpt_dir = op.join(work_dir, "checkpoints")
    if lead:
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
    state = create_train_state(model, cfg, disc=disc, seed=args.seed, mesh=mesh)
    model.to(dev)
    if disc is not None:
        disc.to(dev)

    if args.load_dir:
        ckpt = best_or_last(args.load_dir, prefer_best=args.load_best) or args.load_dir
        state = load_checkpoint(ckpt, target=state)
        logger.info("resumed from checkpoint %s at step %d", ckpt, state.step)

    train_step = make_train_step(model, cfg, disc=disc, gan_k=args.gan_k,
                                 use_3d_disc=args.gan_3d_conv, steps_per_epoch=steps_per_epoch,
                                 mesh=mesh)
    eval_step = make_eval_step(model, cfg, metric_names=[m.lower() for m in args.metrics],
                               mesh=mesh)

    best_f1 = -1.0
    recorder_dir = op.join(work_dir, "recorder")
    step_s, evals = [], []
    metrics_log = open(op.join(work_dir, "metrics.jsonl"), "a") if lead else None

    def log_line(obj):
        if metrics_log is not None:
            metrics_log.write(json.dumps(obj) + "\n")
            metrics_log.flush()

    def predict(batch):
        with torch.no_grad():
            return state.model.eval()(batch["image_units"])

    def run_eval(epoch):
        nonlocal best_f1
        agg, n_b = {}, 0
        batches = iterate_batches(val_ds, args.batch_size, shuffle=False,
                                  num_workers=args.num_workers, mesh=mesh)
        for batch in device_prefetch(batches, dev):
            m = eval_step(state, batch)
            if n_b < args.record_predictions:
                # the whole global batch, in rank order
                parts = gather_to_lead((predict(batch).cpu().numpy(),
                                        batch["voxels"].cpu().numpy()), mesh)
                if lead:
                    import numpy as np

                    os.makedirs(recorder_dir, exist_ok=True)
                    with open(op.join(recorder_dir, f"val-e{epoch}-b{n_b}.pkl"), "wb") as f:
                        pickle.dump({"pred_voxels": np.concatenate([p for p, _ in parts]),
                                     "gt_voxels": np.concatenate([g for _, g in parts]),
                                     "epoch": epoch}, f)
            if args.dump_previews and n_b == 0 and lead:
                # the global batch's first item is rank 0's first
                write_preview(op.join(work_dir, "previews", f"epoch{epoch}.png"),
                              predict(batch), batch)
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n_b += 1
            if args.max_steps_per_epoch and n_b >= args.max_steps_per_epoch:
                break
        agg = {k: v / max(n_b, 1) for k, v in agg.items()}
        agg["epoch"] = epoch
        log_line({"eval": agg})
        logger.info("eval epoch %d: %s", epoch, {k: round(v, 4) for k, v in agg.items()})
        evals.append(agg)
        f1 = agg.get("BinaryMatchF1_sum_c", 0.0)
        if f1 > best_f1:
            best_f1 = f1
            save_checkpoint(op.join(ckpt_dir, f"best-epoch={epoch}"), state, mesh)
        save_checkpoint(op.join(ckpt_dir, "last"), state, mesh)
        return agg

    try:
        if args.test_only:
            run_eval(-1)
            return {"work_dir": work_dir, "state": state, "step_s": step_s, "evals": evals}
        for epoch in range(args.max_epochs):
            t0 = time.time()
            batches = iterate_batches(train_ds, args.batch_size, shuffle=True,
                                      seed=args.seed + epoch, num_workers=args.num_workers,
                                      mesh=mesh)
            for i, batch in enumerate(device_prefetch(batches, dev)):
                ts = time.perf_counter()
                state, logs = train_step(state, batch)
                if cuda:
                    torch.cuda.synchronize(dev)
                step_s.append(time.perf_counter() - ts)
                if i % args.log_frequency == 0:
                    line = {k: float(v) for k, v in logs.items()}
                    line.update(epoch=epoch, step=i, global_step=state.step)
                    log_line({"train": line})
                    logger.info("epoch %d step %d loss %.4f", epoch, i, line["loss"])
                if args.max_steps_per_epoch and i + 1 >= args.max_steps_per_epoch:
                    break
            logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
            run_eval(epoch)
    finally:
        if metrics_log is not None:
            metrics_log.close()
    return {"work_dir": work_dir, "state": state, "step_s": step_s, "evals": evals}


if __name__ == "__main__":
    main()
