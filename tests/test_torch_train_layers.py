"""The port's train-mode layers against the JAX package's: the
spectral-normed conv's backward and written-back vectors (SNConv), and
BatchNorm's train-mode output and running statistics (flax keeps the
biased batch variance), on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables, two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.models import layers as jl
from v2ce_toolbox_tpu_torch.models import layers
from v2ce_toolbox_tpu_torch.utils.weights import (
    _j2t_conv,
    block_from_jax_variables,
    conv_layer_from_jax_variables,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")
RTOL, ATOL = 1e-5, 1e-6
# the bias of the conv before a train-mode BN: its gradient is zero in
# exact arithmetic (BN takes the batch mean out), so both sides hold
# rounding noise, checked as zero relative to the largest gradient
DEAD = "downsample.0.bias"


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _jax_train(module, variables, x, r, mutable):
    """Output, updated collections and parameter gradients of sum(y * r)
    for one train-mode apply."""
    def f(params):
        y, new = module.apply({**variables, "params": params}, x, train=True, mutable=mutable)
        return jnp.sum(y * r), (y, new)

    (_, (y, new)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, new), grads


def test_snconv3d_backward_and_vectors_match_jax():
    """A train-mode forward and backward: the gradient of weight_bar (through
    the power iteration) and the u, v written back equal the JAX SNConv's."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 5, 5, 2).astype(np.float32)
    r = rng.randn(1, 3, 5, 5, 4).astype(np.float32)
    m = jl.SNConv(features=4, kernel_size=(3, 3, 3), strides=(1, 1, 1),
                  padding=((1, 1),) * 3)
    variables = fill_variables(lambda: m.init(jax.random.key(0), jnp.asarray(x)), 1)

    def f(params):
        y, new = m.apply({**variables, "params": params}, jnp.asarray(x), mutable=["sn"])
        return jnp.sum(y * r), new

    (_, new), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(variables["params"])

    conv = layers.SNConv3d(2, 4, 3, padding=1).train()
    p = variables["params"]
    conv.load_state_dict({"module.weight_bar": torch.from_numpy(_j2t_conv(p["kernel_bar"])),
                          "module.weight_u": torch.from_numpy(variables["sn"]["u"]),
                          "module.weight_v": torch.from_numpy(variables["sn"]["v"]),
                          "module.bias": torch.from_numpy(p["bias"])})
    y = conv(_ncdhw(x))
    (y * _ncdhw(r)).sum().backward()
    np.testing.assert_allclose(conv.module.weight_bar.grad.numpy(),
                               _j2t_conv(np.asarray(grads["kernel_bar"])), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(conv.module.bias.grad.numpy(), np.asarray(grads["bias"]),
                               rtol=RTOL, atol=ATOL)
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(conv.module, f"weight_{name}").detach().numpy(),
                                   np.asarray(new["sn"][name]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["conv_layer", "residual_block"])
def test_batchnorm_train_mode_matches_flax(kind):
    """One train-mode forward and backward of a ConvLayer3D (BN momentum
    0.01) or a spectral-normed ResidualBlock3D (0.1, strided): the output,
    every parameter gradient, and the BN running statistics (and SN
    vectors) after the step equal flax's."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 6, 6, 2).astype(np.float32)
    if kind == "conv_layer":
        jm = jl.ConvLayer3D(features=4, kernel_size=3, padding=1, norm="BN")
        port = layers.ConvLayer3D(2, 4, 3, 1, 1, activation="LeakyReLU", norm="BN")
        convert, out_hw, mutable = conv_layer_from_jax_variables, (6, 6), ["batch_stats"]
    else:
        jm = jl.ResidualBlock3D(features=4, stride=(1, 2, 2), norm="BN", sn=True)
        port = layers.ResidualBlock3D(2, 4, (1, 2, 2), "BN", True)
        convert, out_hw, mutable = block_from_jax_variables, (3, 3), ["batch_stats", "sn"]
    r = rng.randn(2, 3, *out_hw, 4).astype(np.float32)
    variables = fill_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x), train=False),
                               3)
    y_j, new, grads = _jax_train(jm, variables, jnp.asarray(x), jnp.asarray(r), mutable)

    port.load_state_dict(convert(variables))
    port.train()
    y = port(_ncdhw(x))
    (y * _ncdhw(r)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.moveaxis(y_j, -1, 1), rtol=RTOL, atol=ATOL)

    after = convert({**variables, **new})
    got = port.state_dict()
    for k, v in after.items():
        if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    gsd = convert({**variables, "params": jax.tree_util.tree_map(np.asarray, grads)})
    trained = {n: p.grad.numpy() for n, p in port.named_parameters() if p.requires_grad}
    scale = max(np.abs(g).max() for g in trained.values())
    for name, g in trained.items():
        if name == DEAD:
            assert max(np.abs(g).max(), np.abs(gsd[name].numpy()).max()) <= 1e-6 * scale
        else:
            # f32 sums through BN's backward: the train step's tolerance
            np.testing.assert_allclose(g, gsd[name].numpy(), rtol=1e-4, atol=ATOL, err_msg=name)
