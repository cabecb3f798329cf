"""The port's UNetPlain3D and ResNet / ResNetDiscriminator against the JAX
package's, on the same weights (flax variables drawn with numpy, carried
across by `unet_plain_from_jax_variables` and `resnet_from_jax_variables`):
outputs within rtol 1e-4 / atol 1e-5 in eval mode, and in train mode with
the BN running statistics (and SN vectors) within 1e-6; the 'sum' skip's
channel mismatch fails on both sides.

The ResNet's running statistics are held within 1e-5 (RESNET_STATE_TOL):
its stage-1 BNs see 160 values a channel at (2, 64, 80), and flax's
variance E[x^2] - E[x]^2 of the LeakyReLU'd activations cancels, so the
reduction-order rounding of the two frameworks reaches 2e-06 of a
running variance of 1.3."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables, two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.models import resnet as jresnet
from v2ce_toolbox_tpu.models.unet_plain import UNetPlain3D as JaxUNetPlain3D
from v2ce_toolbox_tpu_torch.models import ResNet, ResNetDiscriminator, UNetPlain3D
from v2ce_toolbox_tpu_torch.utils.weights import (
    init_weights,
    resnet_from_jax_variables,
    unet_plain_from_jax_variables,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")
RTOL, ATOL, STATE_TOL, RESNET_STATE_TOL = 1e-4, 1e-5, 1e-6, 1e-5
# tests/test_unet_plain.py's configuration and input
PLAIN = dict(num_input_channels=8, num_output_channels=16, skip_type="concat",
             activation="sigmoid", norm="BN")
PLAIN_X = (1, 2, 32, 44, 8)
DISC_X = (2, 64, 80, 20)


def _state_errs(model, ref_sd, tol=STATE_TOL):
    """BN running statistics and SN vectors of the port against ref_sd."""
    sd, n = model.state_dict(), 0
    for k, want in ref_sd.items():
        if "running_" in k or k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=tol, atol=tol,
                                       err_msg=k)
            n += 1
    return n


@functools.cache
def _plain(multi, sn):
    jm = JaxUNetPlain3D(**PLAIN, multi=multi, sn=sn)
    x = np.random.RandomState(0).randn(*PLAIN_X).astype(np.float32)
    return jm, fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 1 + multi), x


def _eval_and_train(jm, v, x, mutable):
    """The JAX module's eval output, train-mode output and updated
    collections, from one jitted call."""
    def f(v, x):
        return jm.apply(v, x), *jm.apply(v, x, train=True, mutable=mutable)

    return jax.jit(f)(v, jnp.asarray(x))


@pytest.mark.parametrize("multi,sn", [(False, False), (True, True)])
def test_unet_plain3d_matches_jax(multi, sn):
    jm, v, x = _plain(multi, sn)
    ref, ref_t, new = _eval_and_train(jm, v, x, ["batch_stats", "sn"])
    model = UNetPlain3D(**PLAIN, multi=multi, sn=sn)
    model.load_state_dict(unet_plain_from_jax_variables(v))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        got_t = model.train()(torch.from_numpy(x))
    refs, gots, refs_t, gots_t = ((ref, got, ref_t, got_t) if multi
                                  else ([ref], [got], [ref_t], [got_t]))
    assert len(gots) == (4 if multi else 1)
    assert gots[-1].shape == (1, 2, 32, 44, 16)
    for g, r in zip(gots + gots_t, refs + refs_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert 0 <= float(gots[-1].min()) and float(gots[-1].max()) <= 1     # sigmoid
    new = jax.tree_util.tree_map(np.asarray, new)
    assert _state_errs(model, unet_plain_from_jax_variables({"params": v["params"], **new})) > 0


def test_unet_plain3d_sum_skip_fails_as_in_jax():
    """skip_type='sum' at the default widths: the upsampled stream (2C
    channels) meets a skip of C at the first decoder, in JAX and in the
    port."""
    x = np.zeros((1, 2, 16, 16, 160), np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: JaxUNetPlain3D().init(jax.random.key(0), jnp.asarray(x)))
    model = UNetPlain3D().eval()
    init_weights(model, 0)
    with pytest.raises(RuntimeError, match="must match the size"), torch.no_grad():
        model(torch.from_numpy(x))


@functools.cache
def _disc():
    """Variables, input and the JAX eval / train outputs, once a process."""
    jm = jresnet.ResNetDiscriminator()
    x = np.random.RandomState(2).randn(*DISC_X).astype(np.float32)
    v = fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 3)
    return v, x, _eval_and_train(jm, v, x, ["batch_stats"])


@pytest.mark.parametrize("train", [False, True])
def test_resnet_discriminator_matches_jax(train):
    v, x, (ref_eval, ref_train, new) = _disc()
    ref = ref_train if train else ref_eval
    model = ResNetDiscriminator()
    model.load_state_dict(resnet_from_jax_variables(v))
    with torch.no_grad():
        got = model.train(train)(torch.from_numpy(x))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    if train:
        new = jax.tree_util.tree_map(np.asarray, new)
        assert _state_errs(model, resnet_from_jax_variables({"params": v["params"], **new}),
                           RESNET_STATE_TOL) > 0


def test_resnet_weights_and_names():
    """A ResNet with other stage depths: the plain classifier's variables
    carry over (no 'resnet' level), the blocks without a projection have
    none, and init_weights seeds the model."""
    jm = jresnet.ResNet(num_classes=5, layers=(1, 2, 1, 1))
    x = np.random.RandomState(4).randn(1, 40, 48, 3).astype(np.float32)
    v = fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 5)
    model = ResNet(num_classes=5, layers=(1, 2, 1, 1), in_channels=3).eval()
    model.load_state_dict(resnet_from_jax_variables(v))
    keys = set(model.state_dict())
    assert "blocks.stage1_block0.downsample_conv.bias" in keys
    assert "blocks.stage0_block0.downsample_conv.weight" not in keys
    assert "blocks.stage1_block1.downsample_bn.weight" not in keys
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    init_weights(model, 0)
    with torch.no_grad():
        assert float(model.fc.bias.abs().max()) == 0 and float(model.fc.weight.std()) > 0
