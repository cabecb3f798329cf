"""K12 of the port (`ops/conv3d_wino4.conv3d_wino4`) against the JAX
package's Pallas Winograd F(4,3) kernel (interpret mode on the CPU), on the
CPU, where the wrapper runs its plain twin.

Tolerances, relative to the JAX output's largest value:
  * 'full', f32 and bf16 in (f32 out): 1e-5. The transforms round at the
    JAX kernel's points (in bf16 every product and partial sum, as its
    bf16 arithmetic does) and the collapses run in its order; only the
    C-long products sum in another order, and U = G k G^T is an f32 einsum
    in each framework.
  * 'nodot', f32: 1e-6. The twin runs the JAX kernel's ops in its order,
    but XLA:CPU contracts the V row 4*e1 - 5*e3 + e5 into an FMA where the
    product 4*e1 is shared inside one of its fusions (ROADMAP P6), so a few
    outputs of the interpreted kernel differ by some f32 ulps; the card's
    kernel is held to the twin bit for bit (tests/test_torch_kernels.py).
  * 'noinv' raises in both packages (ROADMAP R5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import winograd_pallas as jax_wino
from v2ce_toolbox_tpu_torch.ops import conv3d_wino4

SHAPE, CO = (1, 8, 9, 7, 16), 8


def _mk(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(*SHAPE) - 0.5).astype(np.float32)
    k = (rng.rand(3, 3, 3, SHAPE[-1], CO) * 0.05).astype(np.float32)
    return x, k


def _rel(got, want):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("lt,th", [(4, 4), (8, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax(dtype, lt, th):
    x, k = _mk()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_wino.conv3d_wino4(jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt),
                                 lt=lt, th=th)
    got = conv3d_wino4.conv3d_wino4(torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt),
                                    lt=lt, th=th)
    assert _rel(got, want) <= 1e-5


def test_nodot_matches_jax():
    x, k = _mk(seed=1)
    want = jax_wino.conv3d_wino4(jnp.asarray(x), jnp.asarray(k), lt=4, th=4, ablate="nodot")
    got = conv3d_wino4.conv3d_wino4(torch.from_numpy(x), torch.from_numpy(k), lt=4, th=4,
                                    ablate="nodot")
    assert _rel(got, want) <= 1e-6


def test_nodot_lanes_follow_the_channel_padding():
    # c = 16 pads to 128 >= 3 Co: lanes past c copy zero padding; c = 8
    # pads to 8 < 3 Co: the lanes tile V's channels
    assert conv3d_wino4.nodot_lanes(16, 8) == list(range(16)) + [-1] * 8
    assert conv3d_wino4.nodot_lanes(8, 8) == [j % 8 for j in range(24)]


def test_noinv_raises_in_both():
    x, k = _mk()
    with pytest.raises(TypeError):
        jax_wino.conv3d_wino4(jnp.asarray(x), jnp.asarray(k), lt=4, th=4, ablate="noinv")
    with pytest.raises(ValueError, match="noinv"):
        conv3d_wino4.conv3d_wino4(torch.from_numpy(x), torch.from_numpy(k), ablate="noinv")


def test_off_cpu_never_takes_the_twin():
    x = torch.empty((1, 4, 6, 8, 16), device="meta")
    k = torch.empty((3, 3, 3, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_wino4.conv3d_wino4(x, k)
