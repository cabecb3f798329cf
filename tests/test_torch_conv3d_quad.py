"""K11 of the port (`ops/conv3d_quad`: conv3d_quad, conv3d_quad_s122,
fold_s122) against the JAX package's Pallas quad convs (interpret mode on
the CPU), on the CPU, where `quad_core` runs its plain twin.

Tolerances: the outputs within 1e-5 of the JAX output's largest value, f32
and bf16 inputs alike (both sum the exact products of the inputs in f32,
in other orders); the phase fold byte-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import conv3d_quad as jax_quad
from v2ce_toolbox_tpu_torch.ops import conv3d_quad
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

REL_TOL = 1e-5


def _mk(shape, co, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, 3, shape[-1], co) * scale).astype(np.float32)
    return x, k


def _assert_close(got, want):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("l,h,w,cin,cout,ws", [
    (5, 8, 13, 64, 64, 2),          # odd w
    (4, 12, 20, 64, 128, 2),        # co >= 128
    (3, 9, 17, 96, 32, 4),          # the dec3_c1 class (c = 96)
], ids=["odd-w", "co128", "c96"])
def test_quad_twin_matches_jax_f32(l, h, w, cin, cout, ws):
    # three of tests/test_conv3d_quad.py's cases
    x, k = _mk((2, l, h, w, cin), cout, seed=0)
    want = jax_quad.conv3d_quad(jnp.asarray(x), jnp.asarray(k), ws=ws)
    got = conv3d_quad.conv3d_quad(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32
    _assert_close(got, want)


def test_quad_twin_matches_jax_bf16():
    x, k = _mk((1, 3, 8, 14, 64), 32, seed=1)
    want = jax_quad.conv3d_quad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16))
    got = conv3d_quad.conv3d_quad(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.float32
    _assert_close(got, want)


def test_quad_s122_odd_hw_matches_jax():
    x, k = _mk((2, 3, 9, 13, 32), 64, seed=2)
    want = jax_quad.conv3d_quad_s122(jnp.asarray(x), jnp.asarray(k))
    got = conv3d_quad.conv3d_quad_s122(torch.from_numpy(x), torch.from_numpy(k))
    assert tuple(got.shape) == (2, 3, 5, 7, 64)
    _assert_close(got, want)


@pytest.mark.parametrize("h,w", [(9, 13), (8, 12)])
def test_fold_s122_byte_identical(h, w):
    x, k = _mk((1, 2, h, w, 8), 4, seed=3)
    jxf, jk4 = jax_quad.fold_s122(jnp.asarray(x), jnp.asarray(k))
    pxf, pk4 = conv3d_quad.fold_s122(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(pxf.numpy(), np.asarray(jxf))
    np.testing.assert_array_equal(pk4.numpy(), np.asarray(jk4))


def test_off_cpu_never_takes_the_twin():
    x = torch.empty((1, 4, 6, 8, 16), device="meta")
    k = torch.empty((3, 3, 3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_quad.conv3d_quad(x, k)
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_quad.conv3d_quad_s122(x, k)
