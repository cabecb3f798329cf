"""Training state, optimizers and the learning-rate schedule.

The JAX package's `train/state.py` in torch. The generator's optimizer is
torch Adam with weight_decay: the additive L2 before Adam of the JAX
chain (`add_decayed_weights` -> `scale_by_adam`, eps 1e-8). The
schedule is the JAX formula, evaluated in f32 at the optimizer's step
count before the update (as optax does) and set on the optimizer before
each step; the 'step' schedule keeps its floor at `lr_decay_min_lr`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from v2ce_toolbox_tpu_torch.config import TrainConfig
from v2ce_toolbox_tpu_torch.parallel.mesh import broadcast_module
from v2ce_toolbox_tpu_torch.train.gan import init_discriminator, make_disc_optimizer
from v2ce_toolbox_tpu_torch.utils.weights import init_weights


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Union[float, Callable]:
    """A constant lr (lr_scheduler None), or step -> lr stepped per epoch:
    'step' max(lr * rate ** (epoch // decay_steps), min_lr), 'cosine'
    min_lr + (lr - min_lr) * (1 + cos(pi * min(epoch / decay_steps, 1))) / 2.
    Both in the JAX function's op order and precisions (f32 where it
    computes on arrays)."""
    if cfg.lr_scheduler is None:
        return cfg.lr
    if cfg.lr_scheduler not in ("step", "cosine"):
        raise ValueError(f"invalid lr_scheduler {cfg.lr_scheduler!r}")
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = int(step) // max(steps_per_epoch, 1)
        if cfg.lr_scheduler == "step":
            factor = f32(cfg.lr_decay_rate) ** f32(epoch // cfg.lr_decay_steps)
            return float(max(f32(cfg.lr) * factor, f32(cfg.lr_decay_min_lr)))
        t = min(f32(epoch) / f32(cfg.lr_decay_steps), f32(1.0))
        # (lr - min_lr) * 0.5 in f64, as Python evaluates it there
        half = f32((cfg.lr - cfg.lr_decay_min_lr) * 0.5)
        return float(f32(cfg.lr_decay_min_lr) + half * (f32(1) + np.cos(f32(math.pi) * t)))

    return schedule


def trainable(module: nn.Module):
    """The parameters an optimizer updates: the spectral-norm vectors are
    parameters that take no gradient, and are left out."""
    return [p for p in module.parameters() if p.requires_grad]


def make_optimizer(model: nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    """Adam(lr, betas (0.9, 0.999), eps 1e-8, weight_decay); the lr is set
    from the schedule before each step (`set_lr`)."""
    return torch.optim.Adam(trainable(model), lr=cfg.lr, weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, schedule, step: int) -> float:
    lr = schedule(step) if callable(schedule) else schedule
    for group in optimizer.param_groups:
        group["lr"] = lr
    return lr


@dataclasses.dataclass
class TrainState:
    """The generator with its BN statistics and spectral-norm vectors, its
    optimizer, the discriminator and its optimizer (None without the GAN),
    and the step count: one object, one checkpoint."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    disc: Optional[nn.Module] = None
    disc_opt: Optional[torch.optim.Optimizer] = None


def create_train_state(model: nn.Module, cfg: TrainConfig, *, disc: Optional[nn.Module] = None,
                       seed: Optional[int] = None, init: bool = True, mesh=None) -> TrainState:
    """The state of a fresh run: with `init`, the model and the
    discriminator take seeded random weights (seed, seed + 1), else they
    keep theirs. Under a data-parallel `mesh` both move to the rank's
    device and take rank 0's weights and buffers, so every rank starts
    from one state."""
    seed = cfg.seed if seed is None else seed
    if init:
        init_weights(model, seed)
    disc_opt = None
    if disc is not None:
        if init:
            init_discriminator(disc, seed + 1)
        disc_opt = make_disc_optimizer(trainable(disc))
    if mesh is not None:
        for module in (model, disc):
            if module is not None:
                broadcast_module(module.to(mesh.device), mesh)
    return TrainState(model=model, opt=make_optimizer(model, cfg), disc=disc, disc_opt=disc_opt)
