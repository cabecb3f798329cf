"""The port's 2D UNet and V2ce2d against the JAX package's, on the same
weights (flax variables drawn with numpy, carried across by
`unet2d_from_jax_variables`): the eval forward within rtol 1e-4 / atol
1e-5 (the two frameworks sum the conv products in other orders), `multi`
on and off; one train-mode apply's output, BN running statistics and
spectral-norm vectors (statistics and vectors within 1e-6); and the 2D
layers' nearest upsample.

The full-width V2ce2d's train-mode output is held within TRAIN_REL_TOL of
its largest element instead: at (1, 2, 32, 48) its 2x3 bottleneck gives
each BN 12 values a channel, and flax's variance E[x^2] - E[x]^2 cancels,
which lifts the two frameworks' reduction-order rounding on the small
outputs (3.6e-05 at most, 6e-06 of the largest |output| of 6.0)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables, two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.models import unet2d as junet2d
from v2ce_toolbox_tpu_torch.models import UNet2D, V2ce2d
from v2ce_toolbox_tpu_torch.models.layers import upsample_nearest_to
from v2ce_toolbox_tpu_torch.utils.weights import unet2d_from_jax_variables, init_weights

pytestmark = pytest.mark.usefixtures("two_torch_threads")
RTOL, ATOL, STATE_TOL, TRAIN_REL_TOL = 1e-4, 1e-5, 1e-6, 1e-5
NARROW = dict(num_input_channels=2, num_output_channels=6, base_num_channels=8,
              num_encoders=2, num_residual_blocks=1)
# 18 -> 9 -> 5 rows and 26 -> 13 -> 7 columns: odd sizes on both skips
NARROW_X = (2, 18, 26, 2)
V2CE2D_X = (1, 2, 32, 48, 2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


def _eval_and_train(jm, v, x):
    """The JAX module's eval output, train-mode output and updated
    collections, from one jitted call."""
    return jax.jit(lambda v, x: (jm.apply(v, x), *jm.apply(
        v, x, train=True, mutable=["batch_stats", "sn"])))(v, jnp.asarray(x))


@functools.cache
def _narrow(multi):
    """The narrow UNet2D's variables (numpy), one input and the JAX
    outputs on it, once a process."""
    jm = junet2d.UNet2D(**NARROW, multi=multi)
    x = np.random.RandomState(3).randn(*NARROW_X).astype(np.float32)
    v = fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 4 + multi)
    return v, x, _eval_and_train(jm, v, x)


def _port_unet(v, multi):
    m = UNet2D(**NARROW, multi=multi)
    m.load_state_dict(unet2d_from_jax_variables(v))
    return m


def _check_state(model, params, new):
    """The port's BN running statistics and SN vectors against the flax
    collections `new` after the same train-mode apply."""
    sd = model.state_dict()
    new = jax.tree_util.tree_map(np.asarray, new)
    ref = unet2d_from_jax_variables({"params": params, **new})
    n = 0
    for k, want in ref.items():
        if "running_" in k or k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=STATE_TOL,
                                       atol=STATE_TOL, err_msg=k)
            n += 1
    return n


@pytest.mark.parametrize("multi", [False, True])
def test_unet2d_eval_matches_jax(multi):
    v, x, (ref, _, _) = _narrow(multi)
    with torch.no_grad():
        got = _port_unet(v, multi).eval()(_nchw(x))
    refs, gots = (ref, got) if multi else ([ref], [got])
    assert len(gots) == len(refs) == (2 if multi else 1)
    for g, r in zip(gots, refs):
        assert _nhwc(g).shape == r.shape
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert float(np.abs(np.asarray(refs[-1])).max()) > 0


@pytest.mark.parametrize("multi", [False, True])
def test_unet2d_train_apply_matches_jax(multi):
    """One train-mode apply: output (batch statistics), then the BN
    running statistics and the spectral-norm vectors written back."""
    v, x, (_, ref, new) = _narrow(multi)
    model = _port_unet(v, multi).train()
    with torch.no_grad():
        got = model(_nchw(x))
    gots, refs = (got, ref) if multi else ([got], [ref])
    for g, r in zip(gots, refs):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert _check_state(model, v["params"], new) > 0


@functools.cache
def _v2ce2d_vars(multi):
    jm = junet2d.V2ce2d(unet_multi=multi)
    x = np.random.RandomState(5).randn(*V2CE2D_X).astype(np.float32)
    return jm, fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 6), x


@pytest.mark.parametrize("multi", [True, False])
def test_v2ce2d_matches_jax(multi):
    """The full-width V2ce2d (base 32, 4 encoders) in eval and in train
    mode: with multi the last head's prediction."""
    jm, v, x = _v2ce2d_vars(multi)
    ref_eval, ref_train, new = _eval_and_train(jm, v, x)
    model = V2ce2d(unet_multi=multi)
    model.load_state_dict(unet2d_from_jax_variables(v))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.shape == (1, 2, 32, 48, 20)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(ref_eval), rtol=RTOL, atol=ATOL)
    ref_train = np.asarray(ref_train)
    err = float(np.abs(got_train.numpy() - ref_train).max())
    assert err <= TRAIN_REL_TOL * float(np.abs(ref_train).max()), err
    assert _check_state(model, v["params"], new) > 0


def test_v2ce2d_real_multi_out_fails_as_in_jax():
    """real_multi_out reshapes every head's prediction to the input's (H,
    W), but the heads before the last are coarser: the JAX module fails on
    the reshape, and the port fails the same way."""
    x = np.zeros(V2CE2D_X, np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(lambda: junet2d.V2ce2d(real_multi_out=True).init(
            jax.random.key(0), jnp.asarray(x)))
    model = V2ce2d(real_multi_out=True).eval()
    with pytest.raises(RuntimeError, match="shape"), torch.no_grad():
        model(torch.from_numpy(x))


def test_state_dict_names_and_init():
    """Key names of the heads, SN convs and BNs; init_weights seeds the 2D
    model (unit-norm SN vectors, the seed decides the weights)."""
    m = V2ce2d()
    keys = set(m.state_dict())
    for k in ("unet.head.conv1.weight", "unet.head.downsample.1.running_var",
              "unet.encoders.3.bn2.running_mean", "unet.resblocks.1.conv2.module.weight_u",
              "unet.decoders.0.conv1.module.weight_v", "unet.preds.3.conv2d.bias"):
        assert k in keys, k
    assert "unet.head.bn1.weight" not in keys              # the head has no norm
    init_weights(m, 0)
    a = {k: v.clone() for k, v in m.state_dict().items()}
    init_weights(m, 0)
    assert all(torch.equal(a[k], v) for k, v in m.state_dict().items())
    u = m.unet.resblocks[0].conv1.module.weight_u
    assert abs(float(u.norm()) - 1) < 1e-6
    init_weights(m, 1)
    assert not torch.equal(a["unet.head.conv1.weight"], m.state_dict()["unet.head.conv1.weight"])


def test_in_norm_builds_a_batchnorm():
    """norm='IN' builds BatchNorms in the residual blocks, as in JAX: the
    JAX variables load into the port strictly, bn1 and bn2 included."""
    jm = junet2d.UNet2D(**NARROW, norm="IN")
    v = fill_variables(lambda: jm.init(jax.random.key(0), jnp.zeros(NARROW_X)), 8)
    assert "bn1" in v["params"]["encoder_0"]
    m = UNet2D(**NARROW, norm="IN")
    m.load_state_dict(unet2d_from_jax_variables(v))
    assert "encoders.0.bn1.running_var" in m.state_dict()


@pytest.mark.parametrize("hw", [(6, 7), (5, 9)])
def test_upsample_nearest2d_matches_jax(hw):
    """The index gather the UNet2D decoders use, at the 2x and 2x - 1
    targets of ceil-halvings and elsewhere, against the JAX package's
    _upsample2d_nearest_to (whose repeat path it must match)."""
    x = np.random.RandomState(0).randn(2, 4, 5, 3).astype(np.float32)    # NHWC
    for target in ((8, 10), (7, 9), hw):
        ref = np.asarray(junet2d._upsample2d_nearest_to(jnp.asarray(x), target))
        got = upsample_nearest_to(_nchw(x), target)
        np.testing.assert_array_equal(_nhwc(got), ref)
