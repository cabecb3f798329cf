"""Two train steps of the port against two JAX train steps, on the same
weights and batches: the full default loss stack with the GAN (gan_k 2),
the 'step' lr schedule decaying between the steps, at a tiny shape (base
4, 2 encoders, B 2, L 2, 24x24: the PatchGAN's k4 convs leave a 24x24
input one logit and a 16x16 one none). Each port step starts from the
JAX state the JAX step started from (the weights, statistics and both
Adam states carried across), so the second step runs on non-zero
moments and the decayed lr. After each step: every log term, the
generator's parameters, BN statistics and spectral-norm vectors, both
Adam moments, and the discriminator's parameters and moments; then one
eval step's metrics on the JAX state after the second step.

Tolerances: rtol 1e-4, atol 1e-6 elementwise, except for the Adam
moments, which hold each tensor within 1e-4 of its largest element (+
1e-6): they are gradients, and in f32 both sides' gradients sit a few
1e-6 of the tensor's largest element from an f64 run of the port, so
the small elements of a tensor differ by more than 1e-4 of themselves."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.torch_research import fill_variables, two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.config import TrainConfig as JaxTrainConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.train import gan as jgan
from v2ce_toolbox_tpu.train import state as jstate
from v2ce_toolbox_tpu.train import step as jstep
from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.train import gan, state as tstate, step as tstep
from v2ce_toolbox_tpu_torch.utils.weights import discriminator_from_jax_params, from_jax_variables

pytestmark = pytest.mark.usefixtures("two_torch_threads")
TINY = dict(base_num_channels=4, num_encoders=2)
NB = dict(num_encoders=2, num_residual_blocks=2)
B, L, H, W = 2, 2, 24, 24
CFG = dict(loss="pyramid+gan+ef+ef_splitp+compensation", lr=1e-3, weight_decay=1e-5,
           lr_scheduler="step", lr_decay_steps=1, lr_decay_rate=0.5, lr_decay_min_lr=1e-6)
GAN_K, STEPS_PER_EPOCH = 2, 1
RTOL, ATOL = 1e-4, 1e-6
# the bias of each block's projection conv, right before a train-mode BN:
# its gradient is zero in exact arithmetic, so both sides' gradients are
# rounding noise, which Adam scales to +-lr; after a step from the same
# state such a parameter may differ by up to twice the step's lr, and its
# moments by the noise
DEAD = "downsample.0.bias"
LRS = (1e-3, 5e-4)           # the 'step' schedule at counts 0 and 1


def _batch(seed):
    rng = np.random.RandomState(seed)
    units = rng.randn(B, L, H, W, 2).astype(np.float32)
    vox = (rng.rand(B, L, H, W, 20) * 3 * (rng.rand(B, L, H, W, 20) < 0.2)).astype(np.float32)
    return {"image_units": units, "voxels": vox}


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _carry(js, ts):
    """Load the JAX state into the port's: model, discriminator, both
    Adam states (moments and count) and the step."""
    ts.model.load_state_dict(from_jax_variables(js.model_variables(), **NB))
    ts.disc.load_state_dict(discriminator_from_jax_params(js.disc_params))
    for module, opt, opt_state, convert in (
            (ts.model, ts.opt, js.opt_state,
             lambda t: from_jax_variables({**js.model_variables(), "params": t}, **NB)),
            (ts.disc, ts.disc_opt, js.disc_opt_state, discriminator_from_jax_params)):
        adam = _adam(opt_state)
        if int(adam.count) == 0:
            continue
        mu, nu = convert(adam.mu), convert(adam.nu)
        for name, p in module.named_parameters():
            if p.requires_grad:
                opt.state[p] = {"step": torch.tensor(float(adam.count)),
                                "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    ts.step = int(js.step)


@pytest.fixture(scope="module")
def run():
    return _run()


@functools.cache
def _run():
    """Both sides' two steps, each port step from the JAX step's starting
    state, and one eval on the JAX state after them; once a process (numpy
    arrays and floats), so a worker that comes back to this module after
    another one does not run the JAX steps again."""
    jmodel = JaxV2ce3d(config=JaxModelConfig(**TINY))
    jdisc = jgan.PatchDiscriminator2D()
    x0 = jnp.zeros((1, L, H, W, 2), jnp.float32)
    variables = fill_variables(lambda: jmodel.init(jax.random.key(0), x0, train=False), 0)
    dparams = fill_variables(
        lambda: jdisc.init(jax.random.key(1), jnp.zeros((1, H, W, 20), jnp.float32)), 1)["params"]
    jcfg = JaxTrainConfig(**CFG)
    js = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], sn=variables["sn"],
        opt_state=jstate.make_optimizer(jcfg, STEPS_PER_EPOCH).init(variables["params"]),
        disc_params=dparams, disc_opt_state=jgan.make_disc_optimizer().init(dparams))
    jtrain = jstep.make_train_step(jmodel, jcfg, disc=jdisc, gan_k=GAN_K,
                                   steps_per_epoch=STEPS_PER_EPOCH, donate=False)

    model = V2ce3d(ModelConfig(**TINY))
    disc = gan.PatchDiscriminator2D()
    cfg = TrainConfig(**CFG)
    ts = tstate.create_train_state(model, cfg, disc=disc, init=False)
    ttrain = tstep.make_train_step(model, cfg, disc=disc, gan_k=GAN_K,
                                   steps_per_epoch=STEPS_PER_EPOCH)
    steps = []
    for seed in (10, 11):
        b = _batch(seed)
        _carry(jax.tree_util.tree_map(np.asarray, js), ts)
        js, jlogs = jtrain(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tlogs = ttrain(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        steps.append((jax.tree_util.tree_map(np.asarray, (js, jlogs)),
                      {k: float(v) for k, v in tlogs.items()}, _port_snapshot(ts)))
    b = _batch(12)
    jeval = jstep.make_eval_step(jmodel, jcfg)(js, {k: jnp.asarray(v) for k, v in b.items()})
    _carry(jax.tree_util.tree_map(np.asarray, js), ts)
    teval = tstep.make_eval_step(model, cfg)(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    return steps, ({k: float(v) for k, v in jeval.items()}, {k: float(v) for k, v in teval.items()})


def _port_snapshot(ts):
    """The port's state as numpy: the model's state_dict, each trained
    parameter's Adam moments, the discriminator's and its moments."""
    def moments(module, opt):
        out = {}
        for name, p in module.named_parameters():
            if p.requires_grad:
                st = opt.state[p]
                out[name] = (st["exp_avg"].numpy().copy(), st["exp_avg_sq"].numpy().copy())
        return out

    return {"model": {k: v.numpy().copy() for k, v in ts.model.state_dict().items()},
            "moments": moments(ts.model, ts.opt),
            "disc": {k: v.detach().numpy().copy() for k, v in ts.disc.state_dict().items()},
            "disc_moments": moments(ts.disc, ts.disc_opt), "step": ts.step}


def _close(got, want, name, lr=None):
    if lr is not None and DEAD in name:
        assert np.abs(got - want).max() <= 2 * lr * (1 + 1e-3), name
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def _close_to_max(got, want, name):
    """Within RTOL of the tensor's largest element (+ ATOL)."""
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max() + ATOL, (name, err, np.abs(want).max())


def test_logs_match_jax(run):
    for i in (0, 1):
        (_, jlogs), tlogs, _ = run[0][i]
        assert set(tlogs) == set(jlogs)
        for k, v in tlogs.items():
            np.testing.assert_allclose(v, jlogs[k], rtol=RTOL, atol=ATOL, err_msg=f"{k} {i}")


def test_generator_state_matches_jax(run):
    """Parameters, BN statistics and SN vectors after steps 0 and 1."""
    for i in (0, 1):
        (js, _), _, snap = run[0][i]
        want = from_jax_variables(js.model_variables(), **NB)
        assert snap["step"] == int(js.step) == i + 1
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                _close(snap["model"][k], v.numpy(), f"{k} {i}", LRS[i])


def test_adam_moments_match_jax(run):
    for i in (0, 1):
        (js, _), _, snap = run[0][i]
        adam = _adam(js.opt_state)
        assert int(adam.count) == i + 1
        for which, tree in ((0, adam.mu), (1, adam.nu)):
            want = from_jax_variables({**js.model_variables(), "params": tree}, **NB)
            for name, mom in snap["moments"].items():
                got = mom[which]
                if DEAD in name:      # moments of rounding noise
                    assert (np.abs(got - want[name].numpy()).max()
                            <= 1e-5 ** (which + 1)), (name, i)
                else:
                    _close_to_max(got, want[name].numpy(), f"{name} m{which + 1} {i}")


def test_discriminator_matches_jax(run):
    for i in (0, 1):
        (js, _), _, snap = run[0][i]
        want = discriminator_from_jax_params(js.disc_params)
        for k, v in want.items():
            _close(snap["disc"][k], v.numpy(), f"{k} {i}")
        adam = _adam(js.disc_opt_state)
        for which, tree in ((0, adam.mu), (1, adam.nu)):
            want = discriminator_from_jax_params(tree)
            for name, mom in snap["disc_moments"].items():
                _close_to_max(mom[which], want[name].numpy(), f"disc {name} m{which + 1} {i}")


def test_eval_metrics_match_jax(run):
    jm, tm = run[1]
    assert set(tm) == set(jm)
    for k, v in tm.items():
        np.testing.assert_allclose(v, jm[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_pallas_backends_rejected():
    """K9 and K10 are forward-only: training refuses them, as JAX's does."""
    cfg = TrainConfig(loss="pyramid")
    with pytest.raises(ValueError, match="conv_impl='pallas'"):
        tstep.make_train_step(V2ce3d(ModelConfig(**TINY, conv_impl="pallas")), cfg)
    with pytest.raises(ValueError, match="subpixel_impl='pallas'"):
        tstep.make_train_step(V2ce3d(ModelConfig(**TINY, subpixel_decoder=True,
                                                 subpixel_impl="pallas")), cfg)
