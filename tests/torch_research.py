"""Shared set-up of the port's research-configuration tests
(`test_torch_research_*.py`, `test_torch_decoder.py`): flax variables made
with numpy from a seed (shapes from `jax.eval_shape`, so no init forward
runs), the narrow research model on both sides with the same weights, and
the calls each side makes to its K9 / K10 entry."""

import contextlib
import functools
import math
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.ops import conv3d_pallas, decoder_pallas
from v2ce_toolbox_tpu_torch.config import ModelConfig
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.ops import conv3d, decoder
from v2ce_toolbox_tpu_torch.utils.weights import from_jax_variables

from tests.torch_budget import cpu_budget

# base 8, 2 encoders, 1 resblock: K9 takes every conv with cin >= 16
NARROW = dict(base_num_channels=8, num_encoders=2, num_residual_blocks=1)
RESEARCH = dict(conv_impl="pallas", subpixel_decoder=True, subpixel_impl="pallas",
                subpixel_blocks=2)
# 18 -> 9 -> 5 rows, 26 -> 13 -> 7 columns: decoder_0 sees odd H and W
X_SHAPE = (1, 4, 18, 26, 2)


@pytest.fixture(scope="module")
def two_torch_threads():
    """torch on two threads and the worker at a lower priority for a
    module (`tests/torch_budget.py`)."""
    with cpu_budget(2):
        yield


def fill_variables(init_fn, seed):
    """Variables of the shapes `init_fn` would give, drawn with numpy:
    kernels with std 1/sqrt(fan_in), spectral-norm vectors of unit norm,
    non-trivial BN statistics."""
    rng = np.random.RandomState(seed)
    shapes = traverse_util.flatten_dict(jax.eval_shape(init_fn))
    flat = {}
    for path, s in shapes.items():
        name, shape = path[-1], s.shape
        if name in ("kernel", "kernel_bar"):
            v = rng.randn(*shape) / math.sqrt(math.prod(shape[:-1]))
        elif name in ("u", "v"):
            v = rng.randn(*shape)
            v /= np.linalg.norm(v)
        elif name in ("scale", "var"):
            v = rng.rand(*shape) + 0.5
        else:                                   # biases and BN means
            v = rng.randn(*shape) * 0.1
        flat[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(flat)


@functools.cache
def narrow_variables(seed=0):
    """The narrow model's flax variables (numpy), once a process: callers
    only read them."""
    x = jnp.zeros(X_SHAPE, jnp.float32)
    return fill_variables(
        lambda: JaxV2ce3d(config=JaxModelConfig(**NARROW)).init(jax.random.key(0), x,
                                                               train=False), seed)


def narrow_input(seed=1):
    return np.random.RandomState(seed).randn(*X_SHAPE).astype(np.float32)


@contextlib.contextmanager
def record(module, name, calls, key):
    """Record key(args) of every call of module.name."""
    fn = getattr(module, name)

    def inner(*args, **kwargs):
        calls.append(key(args))
        return fn(*args, **kwargs)

    with mock.patch.object(module, name, inner):
        yield calls


def jax_forward(variables, x, compute_dtype, research=True):
    """The JAX model's output (f32 numpy) and the input shapes of its
    Pallas K9 calls and K10 (folded input) calls."""
    cfg = JaxModelConfig(**NARROW, **(RESEARCH if research else {}),
                         compute_dtype=compute_dtype)
    model = JaxV2ce3d(config=cfg)
    k9, k10 = [], []
    with record(conv3d_pallas, "conv3d_3x3x3", k9, lambda a: tuple(a[0].shape)), \
            record(decoder_pallas, "fused_up_concat_conv", k10,
                   lambda a: a[0].shape[:4] + (a[0].shape[4] + 4 * a[1].shape[4],)):
        y = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x))
    return np.asarray(y.astype(jnp.float32)), k9, k10


def port_model(variables, compute_dtype, research=True):
    model = V2ce3d(ModelConfig(**NARROW, **(RESEARCH if research else {}),
                               compute_dtype=compute_dtype))
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, variables),
                            num_encoders=NARROW["num_encoders"],
                            num_residual_blocks=NARROW["num_residual_blocks"])
    model.load_state_dict(sd)
    return model.eval()


def port_forward(model, x):
    """The port's output (f32 numpy) and the input shapes of its K9 and
    K10 plain-twin calls."""
    k9, k10 = [], []
    with record(conv3d, "_conv3d_3x3x3_torch", k9, lambda a: tuple(a[0].shape)), \
            record(decoder, "_fused_conv_even_torch", k10, lambda a: tuple(a[0].shape)), \
            torch.no_grad():
        y = model(torch.from_numpy(x))
    assert y.dtype == torch.float32
    return y.numpy(), k9, k10
