"""What each rank of the port's data-parallel CPU tests runs
(`tests/test_torch_parallel*.py`). The launcher pickles these functions
by name, and a spawned rank imports this module afresh: it imports torch
and the port, never JAX."""

import torch

from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.models.layers import BatchNorm3d, use_global_batch
from v2ce_toolbox_tpu_torch.parallel.mesh import shard_batch
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline
from v2ce_toolbox_tpu_torch.train import gan, state as tstate, step as tstep


def bn_rank(mesh, x, w_out, weight, bias):
    """One train-mode BatchNorm3d forward and backward on this rank's block
    of x (the loss sum(out * w_out) over the global batch): its output,
    input and weight gradients, and running statistics."""
    bn = BatchNorm3d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    use_global_batch(bn, mesh)
    blk = slice(None) if mesh is None else mesh.block(len(x))
    xr = x[blk].clone().requires_grad_(True)
    out = bn.train()(xr)
    (out * w_out[blk]).sum().backward()
    return {"out": out.detach(), "x_grad": xr.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def _moments(opt, module):
    """An Adam's first and second moments of the module's trained
    parameters, by name."""
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    return ({n: opt.state[p]["exp_avg"].numpy().copy() for n, p in named},
            {n: opt.state[p]["exp_avg_sq"].numpy().copy() for n, p in named})


def snapshot(ts):
    """The state as numpy: the model's state_dict, the trained parameters'
    Adam moments (m1, m2), the discriminator's state_dict and Adam moments
    (dm1, dm2)."""
    m1, m2 = _moments(ts.opt, ts.model)
    dm1, dm2 = _moments(ts.disc_opt, ts.disc)
    return {"model": {k: v.numpy().copy() for k, v in ts.model.state_dict().items()},
            "m1": m1, "m2": m2,
            "disc": {k: v.numpy().copy() for k, v in ts.disc.state_dict().items()},
            "dm1": dm1, "dm2": dm2, "step": ts.step}


def train_rank(mesh, model_sd, disc_sd, batch, eval_batch, model_cfg, cfg, gan_k,
               steps_per_epoch):
    """From the given weights: one eval step, then one train step, on this
    rank's block of each global batch (GAN on, PatchDiscriminator2D)."""
    model = V2ce3d(ModelConfig(**model_cfg))
    model.load_state_dict(model_sd)
    disc = gan.PatchDiscriminator2D()
    disc.load_state_dict(disc_sd)
    cfg = TrainConfig(**cfg)
    ts = tstate.create_train_state(model, cfg, disc=disc, init=False, mesh=mesh)

    def local(b):
        return {k: torch.from_numpy(v) for k, v in shard_batch(b, mesh).items()}

    metrics = tstep.make_eval_step(model, cfg, mesh=mesh)(ts, local(eval_batch))
    step = tstep.make_train_step(model, cfg, disc=disc, gan_k=gan_k,
                                 steps_per_epoch=steps_per_epoch, mesh=mesh)
    ts, logs = step(ts, local(batch))
    return {"logs": {k: float(v) for k, v in logs.items()},
            "metrics": {k: float(v) for k, v in metrics.items()}, "state": snapshot(ts)}


def pipeline_rank(mesh, cfg: PipelineConfig, model_sd, clip, out):
    """Stage 1 over the clip (`video_to_voxels`, as numpy), then `run` and
    `run_streaming` into out/{run,streaming}: their result dicts."""
    import os

    from v2ce_toolbox_tpu_torch.io.video import VideoReader

    pipe = V2cePipeline(cfg, device="cpu", seed=3, mesh=mesh)
    pipe.model.load_state_dict(model_sd)
    vidcap = VideoReader(clip, color_mode="GRAY")
    try:
        results = {"voxels": pipe.video_to_voxels(vidcap=vidcap).numpy()}
    finally:
        vidcap.close()
    results["run"] = pipe.run(input_video_path=clip, out_folder=os.path.join(out, "run"))
    results["streaming"] = pipe.run_streaming(input_video_path=clip,
                                              out_folder=os.path.join(out, "streaming"))
    return results
