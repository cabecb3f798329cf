"""Stage 1 of the port against the JAX V2ce3d: weight conversion both
ways, the eval forward (f32, within rtol 1e-4 / atol 1e-5: the two
frameworks sum the conv products in other orders), and the pair
normalization with the center crop."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.pipeline import infer as jax_infer
from v2ce_toolbox_tpu.pipeline.preprocess import normalize_pairs as jax_normalize
from v2ce_toolbox_tpu.utils.torch_compat import (
    convert_v2ce3d_state_dict,
    state_dict_to_numpy,
)
from v2ce_toolbox_tpu_torch.config import ModelConfig
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.pipeline.infer import center_crop
from v2ce_toolbox_tpu_torch.pipeline.preprocess import normalize_pairs
from v2ce_toolbox_tpu_torch.utils.weights import from_jax_variables, init_weights

SMALL = dict(base_num_channels=4, num_encoders=2, num_residual_blocks=1)


@pytest.fixture(scope="module")
def port_model():
    m = V2ce3d(ModelConfig(**SMALL))
    init_weights(m, seed=5)
    with torch.no_grad():   # non-trivial BN statistics
        g = torch.Generator().manual_seed(6)
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm3d):
                mod.running_mean.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.num_features, generator=g) + 0.5)
                mod.weight.copy_(torch.rand(mod.num_features, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
    return m.eval()


def _jax_vars(port_model):
    return convert_v2ce3d_state_dict(state_dict_to_numpy(port_model.state_dict()),
                                     num_encoders=2, num_residual_blocks=1)


def test_state_dict_keys_are_the_reference_names(port_model):
    keys = set(port_model.state_dict())
    for k in ("UNet.head.conv3d.weight", "UNet.head.conv3d.bias",
              "UNet.encoders.0.conv1.weight", "UNet.encoders.1.bn1.running_mean",
              "UNet.encoders.0.downsample.0.weight", "UNet.encoders.0.downsample.1.bias",
              "UNet.resblocks.0.conv1.module.weight_bar",
              "UNet.resblocks.0.conv2.module.weight_u",
              "UNet.decoders.1.conv1.module.weight_v", "UNet.pred.conv3d.weight"):
        assert k in keys, k


def test_from_jax_variables_round_trip(port_model):
    sd = from_jax_variables(_jax_vars(port_model), num_encoders=2, num_residual_blocks=1)
    ref = port_model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k
    fresh = V2ce3d(ModelConfig(**SMALL))
    fresh.load_state_dict(sd)               # strict: every key, every shape


def test_forward_matches_jax(port_model):
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 20, 26, 2).astype(np.float32)
    ref = JaxV2ce3d(config=JaxModelConfig(**SMALL)).apply(
        _jax_vars(port_model), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(torch.from_numpy(x))
    assert got.shape == (1, 3, 20, 26, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert float(got.abs().max()) > 0


def test_eval_forward_does_not_touch_spectral_vectors(port_model):
    before = {k: v.clone() for k, v in port_model.state_dict().items() if "weight_u" in k}
    with torch.no_grad():
        port_model(torch.zeros(1, 2, 8, 8, 2))
    for k, v in before.items():
        assert torch.equal(port_model.state_dict()[k], v)


def test_normalize_pairs_and_center_crop_match():
    frames = np.random.RandomState(1).rand(2, 5, 6, 20).astype(np.float32)
    ref = jax_infer._center_crop(jax_normalize(jnp.asarray(frames)), 12)
    got = center_crop(normalize_pairs(torch.from_numpy(frames)), 12)
    assert got.shape == (2, 4, 6, 12, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
