"""The port's stage-1 research configuration (conv_impl='pallas',
subpixel_decoder with subpixel_impl='pallas', subpixel_blocks=2) in f32,
against the JAX model with the same configuration and weights (its Pallas
kernels in interpret mode), on the CPU, where K9 and K10 run their plain
twins. Tolerance rtol 1e-4 / atol 1e-5: the two frameworks sum the conv
products in other orders. The twins' calls must be exactly the layers the
JAX package sends to its kernels. Also the decoder block at Co = 64, where
K10 runs without the fused projection."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_research as tr
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from v2ce_toolbox_tpu.models.layers import DecoderResidualBlock3D as JaxDecoderBlock
from v2ce_toolbox_tpu_torch.models.layers import DecoderResidualBlock3D
from v2ce_toolbox_tpu_torch.utils.weights import _j2t_conv


@pytest.fixture(scope="module")
def setup():
    return _setup()


@functools.cache
def _setup():
    """The inputs and the JAX model's output, once a process."""
    variables, x = tr.narrow_variables(), tr.narrow_input()
    return variables, x, tr.jax_forward(variables, x, np.float32)


def test_research_model_matches_jax(setup):
    variables, x, (want, jax_k9, jax_k10) = setup
    got, k9, k10 = tr.port_forward(tr.port_model(variables, torch.float32), x)
    assert got.shape == want.shape == (1, 4, 18, 26, 20)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert float(np.abs(want).max()) > 0
    # encoder_0/1 conv2, resblock conv1/conv2, decoder_0 conv2 (decoder_1's
    # conv2 has cin 8); both decoders' conv1 through K10
    assert k9 == jax_k9 and len(k9) == 5
    assert k10 == jax_k10 and len(k10) == 2
    # and it equals the product model on the same weights
    base, k9, k10 = tr.port_forward(tr.port_model(variables, torch.float32, research=False), x)
    assert not k9 and not k10
    np.testing.assert_allclose(got, base, rtol=1e-5, atol=1e-6)


def test_block_without_fused_projection_matches_jax():
    """Co = 64 (decoder_2 at full width): K10 without the projection, the
    residual as the coarse 1x1 conv upsampled plus the skip's; odd H and W,
    non-trivial BN statistics."""
    rng = np.random.RandomState(21)
    coarse = rng.randn(1, 2, 3, 4, 16).astype(np.float32)
    skip = rng.randn(1, 2, 5, 7, 8).astype(np.float32)
    jblock = JaxDecoderBlock(features=64, norm="BN", sn=True, subpixel_impl="pallas")
    variables = tr.fill_variables(
        lambda: jblock.init(jax.random.key(0), jnp.asarray(coarse), jnp.asarray(skip)), 22)
    want = np.asarray(jblock.apply(variables, jnp.asarray(coarse), jnp.asarray(skip)))

    p, s, sn = variables["params"], variables["batch_stats"], variables["sn"]
    sd = {"downsample.0.weight": _j2t_conv(p["downsample_conv"]["kernel"]),
          "downsample.0.bias": p["downsample_conv"]["bias"]}
    for c in ("conv1", "conv2"):
        sd[f"{c}.module.weight_bar"] = _j2t_conv(p[c]["kernel_bar"])
        sd[f"{c}.module.weight_u"] = sn[c]["u"]
        sd[f"{c}.module.weight_v"] = sn[c]["v"]
    for t, j in (("bn1", "bn1"), ("bn2", "bn2"), ("downsample.1", "downsample_bn")):
        sd[f"{t}.weight"], sd[f"{t}.bias"] = p[j]["bn"]["scale"], p[j]["bn"]["bias"]
        sd[f"{t}.running_mean"], sd[f"{t}.running_var"] = s[j]["bn"]["mean"], s[j]["bn"]["var"]
        sd[f"{t}.num_batches_tracked"] = np.zeros((), np.int64)
    block = DecoderResidualBlock3D(24, 64, (1, 1, 1), "BN", True, subpixel_impl="pallas")
    block.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(coarse).permute(0, 4, 1, 2, 3),
                           torch.from_numpy(skip).permute(0, 4, 1, 2, 3))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (1, 2, 5, 7, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert float(np.abs(want).max()) > 0
