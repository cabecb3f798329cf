"""Stage 1 of the port against the JAX V2ce3d: weight conversion both
ways, the eval forward (f32, within rtol 1e-4 / atol 1e-5: the two
frameworks sum the conv products in other orders), the pair
normalization with the center crop, and the model's backend settings
(the rewrites against JAX are in `test_torch_rewrites.py`)."""

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
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

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


def test_from_jax_variables_round_trip(port_model):
    # the state dict's keys are the reference names
    keys = set(port_model.state_dict())
    for k in ("UNet.head.conv3d.weight", "UNet.head.conv3d.bias",
              "UNet.encoders.0.conv1.weight", "UNet.encoders.1.bn1.running_mean",
              "UNet.encoders.0.downsample.0.weight", "UNet.encoders.0.downsample.1.bias",
              "UNet.resblocks.0.conv1.module.weight_bar",
              "UNet.resblocks.0.conv2.module.weight_u",
              "UNet.decoders.1.conv1.module.weight_v", "UNet.pred.conv3d.weight"):
        assert k in keys, k
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
    # an eval forward does not touch the spectral vectors
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


# conv_impl and subpixel_impl values the port once refused
ONCE_REFUSED = [
    dict(conv_impl="fold"), dict(conv_impl="d2"), dict(conv_impl="d2s"),
    dict(conv_impl="wpack"), dict(conv_impl="ko:decoder"),
    dict(subpixel_decoder=True, subpixel_impl="split"),
    dict(subpixel_decoder=True, subpixel_impl="wfold"),
    dict(subpixel_decoder=True)]                        # the default 'pfold'


def test_rewrite_backends_build_and_match_base(port_model):
    """These backends were refused before the JAX package's rewrites were
    ported; now each builds and gives the base model's output from its
    weights, while 'ko:decoder', a knockout predicate the JAX package does
    not know, raises its ValueError."""
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 2, 12, 20, 2).astype(np.float32))
    with torch.no_grad():
        want = port_model.eval()(x)
    assert float(want.abs().max()) > 0
    for kw in ONCE_REFUSED:
        if kw.get("conv_impl") == "ko:decoder":
            with pytest.raises(ValueError, match="unknown knockout predicate 'decoder'"):
                V2ce3d(ModelConfig(**SMALL, **kw))
            continue
        model = V2ce3d(ModelConfig(**SMALL, **kw))
        model.load_state_dict(port_model.state_dict())
        with torch.no_grad():
            got = model.eval()(x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()),
                                   msg=str(kw))


@pytest.mark.parametrize("kw", [dict(conv_impl="cudnn"),
                                dict(subpixel_decoder=True, subpixel_impl="fused")])
def test_unknown_backends_raise(kw):
    with pytest.raises(ValueError, match="unknown"):
        V2ce3d(ModelConfig(**SMALL, **kw))


def test_full_width_subpixel_on_every_decoder_hits_the_co_limit():
    # subpixel_blocks=-1 at ModelConfig() widths sends decoder_0 (Co = 256)
    # to K10, whose Co <= 64 assert fires as the JAX package's does; the
    # research configuration keeps it to the last two decoders (Co 64, 32)
    cfg = dict(conv_impl="pallas", subpixel_decoder=True, subpixel_impl="pallas")
    model = V2ce3d(ModelConfig(**cfg)).eval()
    assert V2ce3d(ModelConfig(**cfg, subpixel_blocks=2)).UNet.decoders[2].__class__.__name__ \
        == "DecoderResidualBlock3D"
    with torch.no_grad(), pytest.raises(AssertionError, match="Co <= 64"):
        model(torch.zeros(1, 1, 16, 16, 2))
