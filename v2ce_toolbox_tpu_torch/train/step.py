"""Training and evaluation steps on one device.

The JAX package's `make_train_step` / `make_eval_step` in torch. A train
step, with the GAN on:
  1. the generator's train-mode forward (BN on batch statistics; the BN
     running statistics and the spectral-norm vectors move once);
  2. `gan_k` discriminator updates on that prediction, detached, and the
     GT voxels;
  3. the loss stack, with the adversarial term through the updated
     discriminator, one backward, one Adam step of the generator.
The JAX step runs the generator's forward twice, once for the
discriminator's input (its state updates dropped) and once inside the
differentiated loss, both from the same parameters and state: the same
values, so the port runs it once and detaches it for step 2.

With a data-parallel `mesh` (`parallel/mesh.py`) the step is the JAX mesh
step on the global batch, each rank holding its block: BatchNorm takes the
global batch's statistics, both optimizers see gradients averaged over the
ranks (an explicit all_reduce after each backward, not DDP: the
adversarial term switches the discriminator's `requires_grad` off, so the
set of parameters with gradients changes from one backward to the next),
and the logs are the global batch's. Parameters, BN statistics and
spectral-norm vectors stay identical on every rank.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from v2ce_toolbox_tpu_torch.config import TrainConfig
from v2ce_toolbox_tpu_torch.models.layers import use_global_batch
from v2ce_toolbox_tpu_torch.parallel.mesh import average_gradients, reduce_mean
from v2ce_toolbox_tpu_torch.train.gan import discriminator_update, generator_adversarial_loss
from v2ce_toolbox_tpu_torch.train.losses import compose_losses
from v2ce_toolbox_tpu_torch.train.metrics import build_metric_suite
from v2ce_toolbox_tpu_torch.train.state import TrainState, make_lr_schedule, set_lr, trainable
from v2ce_toolbox_tpu_torch.utils import runtime


def _split_pred(pred):
    """A dict pred carries 'voxels' plus auxiliary outputs ('imu',
    'physical_atts'); a bare tensor is the voxels."""
    if isinstance(pred, dict):
        return pred["voxels"], pred
    return pred, {}


def _maybe_encoder_loss(loss_names, encoder_loss_fn):
    """A frozen EncoderLoss when '--loss encoder' is asked for and the
    caller gave none."""
    if "encoder" in loss_names and encoder_loss_fn is None:
        from v2ce_toolbox_tpu_torch.train.voxel_encoder import EncoderLoss

        encoder_loss_fn = EncoderLoss()
    return encoder_loss_fn


def check_trainable(model) -> None:
    """K9 and K10 (conv_impl / subpixel_impl 'pallas') are forward-only; the
    other backends (the sub-pixel forms 'split', 'wfold' and 'pfold',
    decoder_split, 'fold', 'd2', 'd2s', 'wpack', 'ko:*') and remat are
    plain torch and train. The messages are the JAX step's."""
    mcfg = getattr(model, "config", None)
    if getattr(mcfg, "conv_impl", "xla") == "pallas":
        raise ValueError(
            "conv_impl='pallas' is forward-only (no custom VJP); "
            "use conv_impl='xla' for training")
    if getattr(mcfg, "subpixel_decoder", False) and getattr(mcfg, "subpixel_impl", "") == "pallas":
        raise ValueError(
            "subpixel_impl='pallas' (fused decoder kernel) is forward-only; "
            "use an XLA subpixel_impl or subpixel_decoder=False for training")


def make_train_step(model, cfg: TrainConfig, *, disc=None, gan_k: int = 3,
                    use_3d_disc: bool = False, steps_per_epoch: int = 1000,
                    encoder_loss_fn=None, mesh=None):
    """train_step(state, batch) -> (state, logs), the state updated in
    place. batch: {'image_units': (B, L, H, W, 2), 'voxels': (B, L, H, W,
    20)} on the model's device (under a `mesh`, this rank's block of the
    global batch), plus 'imu' / 'physical_att' targets for models with
    those outputs. logs: detached 0-dim tensors, 'loss', 'd_loss' and each
    term of the stack."""
    check_trainable(model)
    use_global_batch(model, mesh)
    loss_names = tuple(cfg.loss.split("+"))
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    use_gan = disc is not None and "gan" in loss_names
    encoder_loss_fn = _maybe_encoder_loss(loss_names, encoder_loss_fn)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model.train()
        gt = batch["voxels"]
        pred, pred_extras = _split_pred(model(batch["image_units"]))
        d_loss = torch.zeros((), device=gt.device)
        gan_term = None
        if use_gan:
            state.disc.train()
            d_loss = discriminator_update(state.disc, state.disc_opt, pred, gt, gan_k=gan_k,
                                          use_3d_conv=use_3d_disc, mesh=mesh)
            gan_term = generator_adversarial_loss(state.disc, pred, use_3d_conv=use_3d_disc)
        loss, logs = compose_losses(pred, gt, loss_names, ef_type=cfg.ef_type,
                                    add_base_loss=cfg.add_base_loss, gan_loss_value=gan_term,
                                    encoder_loss_fn=encoder_loss_fn, pred_extras=pred_extras,
                                    batch=batch, mesh=mesh)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(trainable(model), mesh)
        set_lr(state.opt, schedule, state.step)
        state.opt.step()
        state.step += 1
        logs = reduce_mean({k: v.detach() for k, v in dict(logs, loss=loss,
                                                          d_loss=d_loss).items()}, mesh)
        if runtime.debug_checks_enabled():
            runtime.check_finite(logs)
        return state, logs

    return step


def make_eval_step(model, cfg: TrainConfig, *,
                   metric_names: Sequence[str] = ("binarymatch", "binarymatchf1", "poolmse",
                                                  "l1"),
                   encoder_loss_fn=None, mesh=None):
    """eval_step(state, batch) -> {metric: 0-dim tensor, 'val_loss': the
    stack without the GAN}, the model in eval mode, without gradients;
    under a `mesh`, the global batch's values on every rank."""
    suite = build_metric_suite(metric_names, mesh=mesh)
    loss_names = tuple(n for n in cfg.loss.split("+") if n != "gan")
    encoder_loss_fn = _maybe_encoder_loss(loss_names, encoder_loss_fn)

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        pred, pred_extras = _split_pred(state.model.eval()(batch["image_units"]))
        loss, _ = compose_losses(pred, batch["voxels"], loss_names, ef_type=cfg.ef_type,
                                 add_base_loss=cfg.add_base_loss,
                                 encoder_loss_fn=encoder_loss_fn, pred_extras=pred_extras,
                                 batch=batch, mesh=mesh)
        out = {name: fn(pred, batch["voxels"]) for name, fn in suite.items()}
        out["val_loss"] = torch.as_tensor(loss)
        return reduce_mean(out, mesh)

    return step
