"""The port's FastFlowNet (`v2ce_toolbox_tpu_torch/models/fastflownet.py`)
against the JAX package's, on the same numpy inputs and the same weights
(flax variables drawn with numpy from a seed, converted by
`fastflownet_from_jax_variables`): the warp and the channel shuffle, the
full-width net on a (2, 64, 128) pair in both modes, and
`OpticalFlowCalculator`'s pad / resize / crop on a 50x70 pair. Flows
within 1e-4 of the largest |output| (the two frameworks sum the convs in
other orders)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables
from v2ce_toolbox_tpu.models import fastflownet as jffn
from v2ce_toolbox_tpu_torch.models import fastflownet as tffn
from v2ce_toolbox_tpu_torch.utils.weights import fastflownet_from_jax_variables
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return _weights()


@functools.cache
def _weights():
    """(flax variables, the port's state_dict), one draw a process: the
    tests only read them (`load_state_dict` copies)."""
    variables = fill_variables(
        lambda: jffn.FastFlowNet().init(jax.random.key(0), jnp.zeros((1, 64, 64, 6))), 0)
    return variables, fastflownet_from_jax_variables(variables)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _assert_close(got, want, tol=TOL):
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def test_bilinear_warp_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 8, 10, 3).astype(np.float32)
    # identity, and an integer shift by +1 in x: out[y, x] = img[y, x+1]
    out = _nhwc(tffn.bilinear_warp(_nchw(x), torch.zeros(2, 2, 8, 10)))
    np.testing.assert_array_equal(out, x)
    shift = torch.zeros(2, 2, 8, 10)
    shift[:, 0] = 1.0
    out = _nhwc(tffn.bilinear_warp(_nchw(x), shift))
    np.testing.assert_array_equal(out[:, :, :-1], x[:, :, 1:])
    np.testing.assert_array_equal(out[:, :, -1], 0)         # out of bounds: zeros
    # fractional flows reaching past every border
    flow = (rng.randn(2, 8, 10, 2) * 4).astype(np.float32)
    want = np.asarray(jffn.bilinear_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(tffn.bilinear_warp(_nchw(x), _nchw(flow)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (want == 0).any() and (want != 0).any()


def test_channel_shuffle_matches_jax():
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = np.asarray(jffn._channel_shuffle(jnp.asarray(x), 3))
    np.testing.assert_array_equal(_nhwc(tffn.channel_shuffle(_nchw(x), 3)), want)


def test_fastflownet_full_width_matches_jax(weights):
    variables, sd = weights
    net = tffn.FastFlowNet()
    net.load_state_dict(sd)
    net.eval()
    assert sum(p.numel() for p in net.parameters()) == 1366114
    x = np.random.RandomState(1).rand(2, 64, 128, 6).astype(np.float32)
    jnet = jffn.FastFlowNet()
    flow_j, levels_j = jax.jit(lambda v, a: (jnet.apply(v, a),
                                             jnet.apply(v, a, train=True)))(variables, x)
    with torch.no_grad():
        flow_t = net(_nchw(x))
        levels_t = net(_nchw(x), train=True)
    assert flow_t.shape == (2, 2, 16, 32)
    _assert_close(_nhwc(flow_t), np.asarray(flow_j))
    assert len(levels_t) == 5
    for got, want in zip(levels_t, levels_j):
        assert _nhwc(got).shape == want.shape
        _assert_close(_nhwc(got), np.asarray(want))
    assert levels_t[-1].shape == (2, 2, 1, 2)                 # 1/64


def test_optical_flow_calculator_matches_jax(weights):
    variables, sd = weights
    rng = np.random.RandomState(2)
    a = rng.rand(1, 50, 70, 3).astype(np.float32)
    b = rng.rand(1, 50, 70, 3).astype(np.float32)
    ofc_j = jffn.OpticalFlowCalculator(variables=variables)
    want = np.asarray(jax.jit(ofc_j.__call__)(a, b))
    ofc_t = tffn.OpticalFlowCalculator(state_dict=sd, device="cpu")
    got = ofc_t(_nchw(a), _nchw(b))
    assert got.shape == (1, 2, 50, 70) and got.device.type == "cpu"
    _assert_close(_nhwc(got), want)
