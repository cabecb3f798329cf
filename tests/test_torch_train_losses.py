"""The port's training losses, metrics, lr schedules and optimizers
against the JAX package's, on the same numpy arrays. The loss and metric
cases are those of `tests/test_train_losses.py` (ef_type x splitp,
op_type, pool k, add base), as cases of one parametrised test. The
discriminator and the voxel encoder are in `test_torch_train_gan.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.config import TrainConfig as JaxTrainConfig
from v2ce_toolbox_tpu.train import gan as jgan
from v2ce_toolbox_tpu.train import losses as jlosses
from v2ce_toolbox_tpu.train import metrics as jmetrics
from v2ce_toolbox_tpu.train import state as jstate
from v2ce_toolbox_tpu_torch.config import TrainConfig
from v2ce_toolbox_tpu_torch.train import gan, losses, metrics, state

pytestmark = pytest.mark.usefixtures("two_torch_threads")
RTOL, ATOL = 1e-5, 1e-7


def _pair(shape=(2, 4, 6, 7, 20), seed=0, sparsity=0.5):
    """Channels-last pred and GT voxels, non-negative and sparse."""
    rng = np.random.RandomState(seed)
    pred = (rng.rand(*shape) * 2 * (rng.rand(*shape) < sparsity)).astype(np.float32)
    gt = (rng.rand(*shape) * 2 * (rng.rand(*shape) < sparsity)).astype(np.float32)
    return pred, gt


BIG = (2, 4, 16, 18, 20)
# name -> (JAX function, port function, keyword arguments, pair shape, seed, sparsity)
CASES = {
    **{f"pyramid3d[add_base={ab}]": (jlosses.pyramid3d_loss, losses.pyramid3d_loss,
                                     dict(add_base_loss=ab), BIG, 1, 0.5)
       for ab in (False, True)},
    "pyramid_temporal": (jlosses.pyramid_temporal_loss, losses.pyramid_temporal_loss, {},
                         (2, 4, 6, 7, 20), 2, 0.5),
    **{f"event_frame[{ef}-splitp={sp}]": (jlosses.event_frame_loss, losses.event_frame_loss,
                                          dict(ef_type=ef, split_polarity=sp),
                                          (2, 4, 6, 7, 20), 3, 0.5)
       for ef in ("cl", "only_c", "c+cl") for sp in (False, True)},
    "match": (jlosses.match_loss, losses.match_loss, {}, (2, 4, 6, 7, 20), 4, 0.5),
    "compensation": (jlosses.compensation_loss, losses.compensation_loss, {},
                     (2, 4, 6, 7, 20), 5, 0.5),
    "l1_loss": (jlosses.l1_loss, losses.l1_loss, {}, (2, 4, 6, 7, 20), 9, 0.5),
    "l2_loss": (jlosses.l2_loss, losses.l2_loss, {}, (2, 4, 6, 7, 20), 9, 0.5),
    **{f"binary_match[{t}]": (jmetrics.binary_match, metrics.binary_match, dict(op_type=t),
                              (2, 4, 6, 7, 20), 6, 0.3) for t in ("raw", "sum_c", "sum_cp")},
    **{f"binary_match_f1[{t}]": (jmetrics.binary_match_f1, metrics.binary_match_f1,
                                 dict(op_type=t), (2, 4, 6, 7, 20), 6, 0.3)
       for t in ("raw", "sum_c", "sum_cp")},
    **{f"pool_mse[{k}]": (jmetrics.pool_mse, metrics.pool_mse, dict(kernel_size=k), BIG, 7,
                          0.5) for k in (2, 4)},
    "mean_ratio": (jmetrics.mean_ratio, metrics.mean_ratio, {}, (2, 4, 6, 7, 20), 8, 0.5),
    "accuracy": (jmetrics.accuracy, metrics.accuracy, {}, (2, 4, 6, 7, 20), 8, 0.5),
    "l1_metric": (jmetrics.l1_metric, metrics.l1_metric, {}, (2, 4, 6, 7, 20), 8, 0.5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_or_metric_matches_jax(name):
    jfn, tfn, kw, shape, seed, sparsity = CASES[name]
    pred, gt = _pair(shape, seed, sparsity)
    want = float(jfn(jnp.asarray(pred), jnp.asarray(gt), **kw))
    got = tfn(torch.from_numpy(pred), torch.from_numpy(gt), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["norm_l1", "norm_l2"])
def test_norms_match_jax(fn):
    pred, _ = _pair(seed=10)
    np.testing.assert_allclose(float(getattr(losses, fn)(torch.from_numpy(pred))),
                               float(getattr(jlosses, fn)(jnp.asarray(pred))), rtol=RTOL)


def test_metric_suite_matches_jax():
    """The suite's names, in order, and every value, for train.main's
    default metrics plus Acc and MeanRatio."""
    names = ["l1", "binarymatch", "binarymatchf1", "poolmse", "acc", "meanratio"]
    pred, gt = _pair(BIG, seed=11, sparsity=0.3)
    js, ts = jmetrics.build_metric_suite(names), metrics.build_metric_suite(names)
    assert list(ts) == list(js)
    for k in js:
        np.testing.assert_allclose(float(ts[k](torch.from_numpy(pred), torch.from_numpy(gt))),
                                   float(js[k](jnp.asarray(pred), jnp.asarray(gt))),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_compose_losses_default_stack_matches_jax():
    """train_main's default stack with a GAN term: the total, every log
    term, and the gradient of the total with respect to pred."""
    names = ("pyramid", "gan", "ef", "ef_splitp", "compensation", "match", "pt", "l1", "l2",
             "norml1", "norml2")
    pred, gt = _pair(BIG, seed=12)
    gan_value = np.float32(0.731)

    def jtotal(p):
        total, logs = jlosses.compose_losses(p, jnp.asarray(gt), names,
                                             gan_loss_value=jnp.asarray(gan_value))
        return total, logs

    (jt, jl), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tt, tl = losses.compose_losses(tp, torch.from_numpy(gt), names,
                                   gan_loss_value=torch.tensor(gan_value))
    tt.backward()
    assert set(tl) == set(jl)
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=RTOL)
    for k in jl:
        np.testing.assert_allclose(float(tl[k].detach()), float(jl[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    g = np.asarray(jg)
    assert np.abs(tp.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_compose_losses_checks_match_jax():
    """The same ValueErrors (unknown names, imu without its outputs,
    encoder without a network), the imu and physical branches' values,
    and 'physical' skipped without attention maps."""
    pred, gt = _pair((1, 2, 16, 16, 20), seed=4)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    for names, match in ((("pyramid", "pyramd"), "Invalid loss"), (("imu",), "imu"),
                         (("encoder",), "encoder")):
        with pytest.raises(ValueError, match=match):
            jlosses.compose_losses(jnp.asarray(pred), jnp.asarray(gt), names)
        with pytest.raises(ValueError, match=match):
            losses.compose_losses(tp, tg, names)
    rng = np.random.RandomState(4)
    extras = {"imu": rng.rand(1, 2, 6), "atts": [rng.rand(1, 2, 4, 4, 1) for _ in range(2)],
              "gt_imu": rng.rand(1, 2, 6), "gt_att": rng.rand(1, 2, 4, 4, 1)}
    extras = {k: (np.float32(v) if not isinstance(v, list) else [np.float32(a) for a in v])
              for k, v in extras.items()}

    def run(t, lib):
        return lib.compose_losses(
            t(pred), t(gt), ("imu", "physical", "l2"),
            pred_extras={"imu": t(extras["imu"]), "physical_atts": [t(a) for a in extras["atts"]]},
            batch={"imu": t(extras["gt_imu"]), "physical_att": t(extras["gt_att"])})

    (jt, jl), (tt, tl) = run(jnp.asarray, jlosses), run(torch.from_numpy, losses)
    assert set(tl) == set(jl) == {"imu_loss", "att_loss", "l2"}
    np.testing.assert_allclose(float(tt), float(jt), rtol=RTOL)
    _, tl2 = losses.compose_losses(tp, tg, ("physical", "l2"),
                                   batch={"physical_att": torch.from_numpy(extras["gt_att"])})
    assert "att_loss" not in tl2


@pytest.mark.parametrize("sched", ["step", "cosine", None])
def test_lr_schedule_matches_jax_exactly(sched):
    """The schedule at several optimizer counts, bit for bit (f32), with
    steps_per_epoch 3 and the floor of the 'step' schedule reached."""
    kw = dict(lr=1e-3, lr_scheduler=sched, lr_decay_steps=2, lr_decay_rate=0.5,
              lr_decay_min_lr=1e-4)
    js = jstate.make_lr_schedule(JaxTrainConfig(**kw), 3)
    ts = state.make_lr_schedule(TrainConfig(**kw), 3)
    if sched is None:
        assert ts == js == 1e-3
        return
    for count in (0, 1, 2, 3, 5, 6, 11, 12, 17, 18, 30, 100):
        want = np.float32(js(jnp.asarray(count, jnp.int32)))
        assert np.float32(ts(count)) == want, (count, ts(count), want)


def test_optimizers_match_optax():
    """Three Adam steps of the generator's and the discriminator's
    optimizers against the optax chains, on the same gradients."""
    import optax

    rng = np.random.RandomState(5)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    cfg = dict(lr=1e-3, weight_decay=1e-5, lr_scheduler=None)
    for make_j, make_t in (
            (lambda: jstate.make_optimizer(JaxTrainConfig(**cfg)),
             lambda m: state.make_optimizer(m, TrainConfig(**cfg))),
            (jgan.make_disc_optimizer, lambda m: gan.make_disc_optimizer(m.parameters()))):
        tx, jp = make_j(), jnp.asarray(p0)
        opt_state = tx.init(jp)
        m = torch.nn.Linear(1, 1, bias=False)
        m.weight = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make_t(m)
        for g in grads:
            upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
            jp = optax.apply_updates(jp, upd)
            m.weight.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(m.weight.detach().numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-7)
