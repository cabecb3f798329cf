"""K9 of the port (`ops/conv3d.conv3d_3x3x3`) against the JAX package's
Pallas `conv3d_3x3x3` (interpret mode on the CPU), on the CPU, where the
wrapper runs its plain twin.

Tolerances: f32 within rtol 1e-4 / atol 1e-5 (the two sum the 27 * C
products in other orders); bf16 inputs within rtol / atol 0.05, the bound
of the JAX package's own bf16 check (`tests/test_decoder_pallas.py:67-76`),
where both outputs round to bf16 and one f32 sum may straddle a rounding
boundary in the other's order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.conv3d_pallas import conv3d_3x3x3 as jax_conv3d
from v2ce_toolbox_tpu_torch.ops import conv3d
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _mk(shape, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, shape[-1], co) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,co", [
    ((1, 4, 6, 16, 16), 16),        # cin 16: the edge of the model's guard
    ((2, 3, 5, 13, 24), 40),        # W not a multiple of 16, Co past 32
], ids=["cin16-L4", "w13-b2"])
def test_twin_matches_jax_f32(shape, co):
    x, k = _mk(shape, co, seed=shape[-1])
    want = np.asarray(jax_conv3d(jnp.asarray(x), jnp.asarray(k)))
    got = conv3d.conv3d_3x3x3(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_twin_matches_jax_bf16():
    x, k = _mk((1, 4, 5, 11, 32), 16, seed=9)
    want = jax_conv3d(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                      out_dtype=jnp.bfloat16)
    got = conv3d.conv3d_3x3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0.05, atol=0.05)


def test_off_cpu_never_takes_the_twin():
    x = torch.empty((1, 4, 6, 8, 16), device="meta")
    k = torch.empty((3, 3, 3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d.conv3d_3x3x3(x, k)
