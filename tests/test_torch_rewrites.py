"""The stage-1 model's rewrites in the port against the JAX package, on
seeded numpy inputs at tiny shapes: the sub-pixel decoder's folds
('split', 'wfold', 'pfold') at every odd/even target parity and the
projection's 1x1 conv (`ops/subpixel.py`), width packing at
`tests/test_wpack.py`'s cases (`ops/wpack.py`), Winograd F(2x2,3x3)
(`ops/winograd.py`), the research conv backends of `ops/research.py`
('fold', 'd2', 'd2s', 'wpack' and every knockout predicate), V2ce3d in
every variant of `tests/test_model_rewrites.py` plus 'd2s', 'wpack' and
'ko:all' on one set of JAX variables, gradients through decoder_split +
'fold' and the 'pfold' sub-pixel decoder against `jax.grad`, remat
against no remat (exactly equal), and the refusals' messages.

Tolerances: the folds as `tests/test_subpixel.py` holds them (2e-5), the
1x1 conv 1e-6; width packing as `tests/test_wpack.py` (rtol 2e-5, atol
2e-4); the model variants at JAX's own rewrite test's rtol 1e-5 / atol
1e-6; a bf16 fold within 8e-3 of the largest output (a bf16 conv in
torch rounds its sums to bf16, where XLA returns f32); gradients within
1e-4 of each tensor's largest element (+ 1e-6), as the train-step test
holds its Adam moments, and the projection biases before a train-mode BN
(gradient zero in exact arithmetic) within 1e-5."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_research import fill_variables
from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.config import PipelineConfig as JaxPipelineConfig
from v2ce_toolbox_tpu.config import TrainConfig as JaxTrainConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.ops import research as jresearch
from v2ce_toolbox_tpu.ops import subpixel as jsub
from v2ce_toolbox_tpu.ops import winograd as jwino
from v2ce_toolbox_tpu.ops import wpack as jwpack
from v2ce_toolbox_tpu.pipeline import driver as jdriver
from v2ce_toolbox_tpu.train import step as jstep
from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.ops import research, subpixel, winograd, wpack
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline
from v2ce_toolbox_tpu_torch.train import step as tstep
from v2ce_toolbox_tpu_torch.utils.weights import from_jax_variables

# 36 -> 18 -> 9 -> 5 rows, 44 -> 22 -> 11 -> 6 columns: decoder_0 goes
# 5x6 -> 9x11, odd on both axes, so the corner term runs
SMALL = dict(num_encoders=3, base_num_channels=4)
NB = dict(num_encoders=3, num_residual_blocks=2)
X_SHAPE = (1, 4, 36, 44, 2)
VARIANTS = {
    "split": dict(decoder_split=True),
    "cm": dict(out_layout="cm"),
    "fold": dict(conv_impl="fold"),
    "d2": dict(conv_impl="d2"),
    "all": dict(decoder_split=True, out_layout="cm", conv_impl="fold"),
    "sp-split": dict(subpixel_decoder=True, subpixel_impl="split"),
    "sp-wfold": dict(subpixel_decoder=True, subpixel_impl="wfold"),
    "sp-pfold": dict(subpixel_decoder=True, subpixel_impl="pfold"),
    "sp-pfold-last1": dict(subpixel_decoder=True, subpixel_impl="pfold", subpixel_blocks=1),
    "sp-wfold-last2": dict(subpixel_decoder=True, subpixel_impl="wfold", subpixel_blocks=2),
    "sp-pallas-last2": dict(subpixel_decoder=True, subpixel_impl="pallas", subpixel_blocks=2),
    "d2s": dict(conv_impl="d2s"),
    "wpack": dict(conv_impl="wpack"),
    "ko:all": dict(conv_impl="ko:all"),
}
DEAD = "downsample.0.bias"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ncdhw(x):
    """(B, L, H, W, C) numpy -> NCDHW torch."""
    return _t(x).permute(0, 4, 1, 2, 3)


def _oidhw(k):
    """(kd, kh, kw, C, Co) numpy -> (Co, C, kd, kh, kw) torch."""
    return _t(k).permute(4, 3, 0, 1, 2)


def _cl(y):
    """NCDHW torch -> (B, L, H, W, C) numpy."""
    return y.permute(0, 2, 3, 4, 1).numpy()


def test_subpixel_folds_match_jax():
    """The three folds at every target parity and at the model's pairs, in
    f32, pfold also in bf16 at both odd axes; the 1x1 projection."""
    forms = {"split": (jsub.conv3d_on_nearest_up2, subpixel.conv3d_on_nearest_up2),
             "wfold": (jsub.conv3d_on_nearest_up2_wfold, subpixel.conv3d_on_nearest_up2_wfold),
             "pfold": (jsub.conv3d_on_nearest_up2_pfold, subpixel.conv3d_on_nearest_up2_pfold)}
    cases = [(6, 5, 8, 4, (12 - oh, 10 - ow)) for oh in (0, 1) for ow in (0, 1)]
    cases += [(9, 11, 4, 2, (18, 22)), (9, 11, 4, 2, (17, 21))]
    for i, (hc, wc, c, co, target) in enumerate(cases):
        rng = np.random.RandomState(7 + i)
        coarse = rng.randn(2, 3, hc, wc, c).astype(np.float32)
        kernel = rng.randn(3, 3, 3, c, co).astype(np.float32)
        for name, (jf, tf) in forms.items():
            want = np.asarray(jax.jit(jf, static_argnums=2)(jnp.asarray(coarse),
                                                            jnp.asarray(kernel), target))
            got = _cl(tf(_ncdhw(coarse), _oidhw(kernel), target))
            assert got.shape == want.shape, (name, target)
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=f"{name} {target}")
    rng = np.random.RandomState(13)
    coarse = rng.randn(1, 2, 5, 6, 16).astype(np.float32)
    kernel = (rng.randn(3, 3, 3, 16, 8) / 12).astype(np.float32)
    want = np.asarray(jax.jit(jsub.conv3d_on_nearest_up2_pfold, static_argnums=2)(
        jnp.asarray(coarse, jnp.bfloat16), jnp.asarray(kernel, jnp.bfloat16), (9, 11)))
    got = _cl(subpixel.conv3d_on_nearest_up2_pfold(_ncdhw(coarse).bfloat16(),
                                                   _oidhw(kernel).bfloat16(), (9, 11)))
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 8e-3 * np.abs(want).max()

    rng = np.random.RandomState(3)
    coarse = rng.randn(1, 2, 4, 5, 6).astype(np.float32)
    kernel = rng.randn(1, 1, 1, 6, 3).astype(np.float32)
    want = np.asarray(jsub.conv1x1_on_nearest_up2(jnp.asarray(coarse), jnp.asarray(kernel),
                                                  (7, 10)))
    got = _cl(subpixel.conv1x1_on_nearest_up2(_ncdhw(coarse), _oidhw(kernel), (7, 10)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


WPACK_CASES = [
    # (h, w, cin, cout, strides, ws): `tests/test_wpack.py`'s CASES
    (13, 23, 2, 8, (1, 1, 1), None),
    (13, 23, 6, 8, (1, 2, 2), None),
    (14, 22, 8, 16, (1, 2, 2), None),
    (13, 21, 16, 4, (1, 1, 1), 4),
    (12, 24, 16, 4, (1, 1, 1), 2),
    (9, 17, 32, 32, (1, 1, 1), 1),
    (10, 20, 12, 128, (1, 1, 1), None),
    (11, 19, 8, 8, (1, 2, 2), 4),
]


def test_wpack_and_winograd_match_jax():
    """conv3d_wpack at every case, its packed weights and inputs, and its
    kernel gradient against jax.grad's; conv3d_winograd at an odd size."""
    for h, w, cin, cout, strides, ws in WPACK_CASES:
        rng = np.random.RandomState(0)
        x = rng.randn(2, 3, h, w, cin).astype(np.float32)
        k = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
        want = np.asarray(jax.jit(jwpack.conv3d_wpack, static_argnums=(2, 3, 4))(
            jnp.asarray(x), jnp.asarray(k), strides, jnp.float32, ws))
        got = _cl(wpack.conv3d_wpack(_ncdhw(x), _oidhw(k), strides, ws=ws))
        assert got.shape == want.shape, (h, w, cin, cout, strides, ws)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
        # the packed weights hold the JAX ones' values, in torch's layout
        wsz = ws or wpack._pick_ws(cout)
        np.testing.assert_array_equal(
            wpack.pack_weights(_oidhw(k), wsz, strides[2]).permute(2, 3, 4, 1, 0).numpy(),
            np.asarray(jwpack.pack_weights(jnp.asarray(k), wsz, strides[2])))

    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 8, 12, 4).astype(np.float32)
    k = (rng.randn(3, 3, 3, 4, 4) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda kk: jwpack.conv3d_wpack(jnp.asarray(x), kk).sum()))(
        jnp.asarray(k)))
    tk = _oidhw(k).clone().requires_grad_()
    wpack.conv3d_wpack(_ncdhw(x), tk).sum().backward()
    np.testing.assert_allclose(tk.grad.permute(2, 3, 4, 1, 0).numpy(), want, rtol=2e-5, atol=2e-4)

    rng = np.random.RandomState(2)
    x = rng.randn(1, 4, 9, 13, 6).astype(np.float32)
    k = (rng.randn(3, 3, 3, 6, 4) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jwino.conv3d_winograd)(jnp.asarray(x), jnp.asarray(k)))
    got = winograd.conv3d_winograd(_t(x), _t(k)).numpy()
    assert got.shape == want.shape == (1, 4, 9, 13, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(winograd.filter_transform(_t(k)).numpy(),
                               np.asarray(jwino.filter_transform(jnp.asarray(k))), rtol=1e-6)


def test_dispatch_conv_matches_jax():
    """dispatch_conv for 'fold', 'd2', 'd2s', 'wpack', every knockout
    predicate and 'xla', on a head-like, a strided, a small-Co and a
    wide-input conv (so each predicate both fires and passes), against the
    JAX dispatch_conv: f32 inputs within 1e-5 of the largest output, and
    bf16 inputs for the rewrites on the strided and the small-Co conv
    within 8e-3."""
    impls = ["xla", "fold", "d2", "d2s", "wpack"] + [f"ko:{p}" for p in
                                                     ("all", "head", "strided", "small", "big")]
    convs = [(2, 8, (1, 1, 1)), (8, 16, (1, 2, 2)), (16, 8, (1, 1, 1)), (256, 8, (1, 1, 1))]
    pad = ((1, 1),) * 3
    jdispatch = jax.jit(jresearch.dispatch_conv, static_argnums=(2, 3, 4, 5))
    for cin, cout, strides in convs:
        rng = np.random.RandomState(cin)
        x = rng.randn(1, 3, 9, 11, cin).astype(np.float32)
        k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
        for impl in impls:
            dtypes = [(jnp.float32, torch.float32, 1e-5)]
            if cin in (8, 16) and impl in ("fold", "d2", "wpack", "ko:all"):
                dtypes.append((jnp.bfloat16, torch.bfloat16, 8e-3))
            for jdt, tdt, tol in dtypes:
                want = np.asarray(jdispatch(jnp.asarray(x), jnp.asarray(k), strides, pad, jdt,
                                            impl))
                got = _cl(research.dispatch_conv(_ncdhw(x), _oidhw(k), strides, 1, tdt, impl))
                assert got.shape == want.shape and got.dtype == np.float32, (impl, cin)
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err <= tol, (impl, cin, cout, strides, str(tdt), err)


@functools.cache
def _model_setup():
    """One set of JAX variables, the input, and each variant's JAX output
    (numpy), once a process."""
    x = np.random.RandomState(1).rand(*X_SHAPE).astype(np.float32)
    jx = jnp.asarray(x)
    variables = fill_variables(
        lambda: JaxV2ce3d(config=JaxModelConfig(**SMALL)).init(jax.random.key(0), jx,
                                                              train=False), 0)
    outs = {}
    for name, kw in dict(base={}, **VARIANTS).items():
        model = JaxV2ce3d(config=JaxModelConfig(**SMALL, **kw))
        outs[name] = np.asarray(jax.jit(lambda v, x, m=model: m.apply(v, x, train=False))(
            variables, jx))
    return x, variables, outs


def _port(kw, variables):
    model = V2ce3d(ModelConfig(**SMALL, **kw))
    model.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, variables), **NB))
    return model


def test_model_variants_match_jax():
    """Every variant of the port's V2ce3d against the same variant of the
    JAX model, on one set of variables, and the port's rewrites against its
    base, at rtol 1e-5 and atol 1e-6 of the largest output (1.32: JAX's own
    test's outputs are of order 1, and across the two frameworks the f32
    sums part by up to 1.4e-6 on this window); 'cm' in its (B, L, 20, H, W)
    layout."""
    x, variables, outs = _model_setup()
    scale = np.abs(outs["base"]).max()
    assert scale > 0
    base = None
    for name, kw in dict(base={}, **VARIANTS).items():
        with torch.no_grad():
            got = _port(kw, variables).eval()(_t(x)).numpy()
        want = outs[name]
        if kw.get("out_layout") == "cm":
            assert got.shape == want.shape == (1, 4, 20, 36, 44)
            got, want = got.transpose(0, 1, 3, 4, 2), want.transpose(0, 1, 3, 4, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale, err_msg=name)
        base = got if base is None else base
        if not name.startswith("ko:"):
            np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-6 * scale, err_msg=name)


def _grads_and_state(model, x):
    model.train()
    y = model(_t(x))
    (y * y).mean().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return y.detach(), grads, {k: v.clone() for k, v in model.state_dict().items()}


def test_remat_is_exact():
    """remat recomputes the blocks in the backward: the output, every
    gradient, the BN running statistics (one update a step) and the
    spectral-norm vectors (one power iteration) exactly equal to those
    without remat, for the base model and for decoder_split with the pfold
    sub-pixel decoder on the last two decoders; in eval the outputs too."""
    x, variables, _ = _model_setup()
    for kw in ({}, dict(decoder_split=True, subpixel_decoder=True, subpixel_blocks=2)):
        plain = _port(kw, variables)
        ref = _grads_and_state(plain, x)
        model = _port(dict(kw, remat=True), variables)
        got = _grads_and_state(model, x)
        assert torch.equal(got[0], ref[0]), kw
        assert got[1].keys() == ref[1].keys() and len(ref[1]) > 0
        for k in ref[1]:
            assert torch.equal(got[1][k], ref[1][k]), (kw, k)
        for k in ref[2]:
            assert torch.equal(got[2][k], ref[2][k]), (kw, k)
        assert any("weight_u" in k for k in ref[2]) and any("running_var" in k for k in ref[2])
        with torch.no_grad():
            assert torch.equal(model.eval()(_t(x)), plain.eval()(_t(x)))


def test_rewrite_gradients_match_jax():
    """One train-mode forward of decoder_split + 'fold' and of the pfold
    sub-pixel decoder, the loss mean(y^2), beside the base model as the
    control: the port's gradients against jax.grad's, its BN statistics
    and spectral-norm vectors against the JAX forward's updated
    collections; and every XLA variant and remat builds a train step.

    Base 4, 2 encoders, B 2, L 2 as the train-step test, at 22x26, whose
    decoder_0 goes 6x7 -> 11x13 (both axes odd). Where a ReLU input lies
    within rounding of 0, any two f32 implementations part there (ROADMAP
    P11; on the 36x44 window above one such element moves the base
    model's gradients by 3.6% of their largest, JAX's and the port's
    alike): the control shows this input has none."""
    x = np.random.RandomState(0).randn(2, 2, 22, 26, 2).astype(np.float32)
    tiny, nb = dict(num_encoders=2, base_num_channels=4), dict(num_encoders=2,
                                                             num_residual_blocks=2)
    variables = fill_variables(lambda: JaxV2ce3d(config=JaxModelConfig(**tiny)).init(
        jax.random.key(0), jnp.asarray(x), train=False), 0)
    for kw in ({}, dict(decoder_split=True, conv_impl="fold"),
               dict(subpixel_decoder=True, subpixel_impl="pfold")):
        jmodel = JaxV2ce3d(config=JaxModelConfig(**tiny, **kw))

        def loss(params, jmodel=jmodel):
            y, upd = jmodel.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                  mutable=["batch_stats", "sn"])
            return jnp.mean(y * y), upd

        jgrads, upd = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
        want = from_jax_variables({**upd, "params": jgrads}, **nb)
        model = V2ce3d(ModelConfig(**tiny, **kw))
        model.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, variables),
                                                 **nb))
        _, grads, state = _grads_and_state(model, x)
        assert grads.keys() <= want.keys() and len(grads) > 20
        for name, g in grads.items():
            w, err = want[name].numpy(), np.abs(g.numpy() - want[name].numpy()).max()
            if DEAD in name:
                assert err <= 1e-5, (kw, name, err)
            else:
                assert err <= 1e-4 * np.abs(w).max() + 1e-6, (kw, name, err, np.abs(w).max())
                assert np.abs(w).max() > 0, (kw, name)
        for name, v in state.items():
            if "running_" in name or "weight_u" in name or "weight_v" in name:
                np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{kw} {name}")
    for kw in [dict(kw) for kw in VARIANTS.values() if "pallas" not in kw.values()] + [
            dict(remat=True)]:
        tstep.check_trainable(V2ce3d(ModelConfig(**SMALL, **kw)))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_match_jax():
    """The train step refuses K9 and K10 with the JAX step's messages, the
    pipeline refuses out_layout 'cm' with the JAX pipeline's, and an
    unknown conv_impl or knockout predicate raises the JAX dispatch's
    ValueError (at construction in the port, at the first conv in JAX)."""
    cfg, jcfg = TrainConfig(), JaxTrainConfig()
    for kw in (dict(conv_impl="pallas"), dict(subpixel_decoder=True, subpixel_impl="pallas")):
        want = _message(lambda: jstep.make_train_step(
            JaxV2ce3d(config=JaxModelConfig(**SMALL, **kw)), jcfg))
        assert _message(lambda: tstep.make_train_step(
            V2ce3d(ModelConfig(**SMALL, **kw)), cfg)) == want
    assert "use an XLA subpixel_impl or subpixel_decoder=False" in want
    want = _message(lambda: jdriver.V2cePipeline(
        JaxPipelineConfig(model=JaxModelConfig(out_layout="cm"))))
    assert _message(lambda: V2cePipeline(
        PipelineConfig(model=ModelConfig(**SMALL, out_layout="cm")), device="cpu")) == want
    x = jnp.zeros((1, 3, 5, 5, 4))
    k = jnp.zeros((3, 3, 3, 4, 4))
    for ci in ("cudnn", "ko:decoder"):
        want = _message(lambda: jresearch.dispatch_conv(x, k, (1, 1, 1), ((1, 1),) * 3,
                                                        jnp.float32, ci))
        assert _message(lambda: V2ce3d(ModelConfig(**SMALL, conv_impl=ci))) == want
    assert _message(lambda: V2ce3d(ModelConfig(**SMALL, out_layout="ncdhw"))) \
        == "unknown out_layout 'ncdhw'"
