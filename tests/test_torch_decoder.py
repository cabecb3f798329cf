"""K10 of the port (`ops/decoder.fused_up_concat_conv`) against the JAX
package's Pallas `fused_up_concat_conv` (interpret mode), on the CPU,
where the wrapper runs its plain twin.

Tolerances: f32 within rtol / atol 1e-4, as the JAX package's own test of
the kernel (`tests/test_decoder_pallas.py`); bf16 within rtol / atol 0.05,
its bf16 bound (there `:67-76`): both fold the weights in f32 and round
them to bf16, and both round the f32 sums to bf16."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.decoder_pallas import fused_up_concat_conv as jax_fused
from v2ce_toolbox_tpu_torch.ops import decoder
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _mk(hc, wc, hf, wf, cu, cs, co, seed=0, l=4, proj=False):
    rng = np.random.RandomState(seed)
    coarse = rng.randn(1, l, hc, wc, cu).astype(np.float32)
    skip = rng.randn(1, l, hf, wf, cs).astype(np.float32)
    kernel = (rng.randn(3, 3, 3, cu + cs, co) * 0.1).astype(np.float32)
    pk = (rng.randn(1, 1, 1, cu + cs, co) * 0.1).astype(np.float32) if proj else None
    return coarse, skip, kernel, pk


def _both(arrays, jdt=jnp.float32, tdt=torch.float32):
    """JAX's and the port's outputs on the same inputs, as f32 numpy lists."""
    coarse, skip, kernel, pk = arrays
    j = jax_fused(*(jnp.asarray(a, jdt) for a in (coarse, skip, kernel)),
                  None if pk is None else jnp.asarray(pk, jdt), out_dtype=jdt)
    t = decoder.fused_up_concat_conv(
        *(torch.from_numpy(a).to(tdt) for a in (coarse, skip, kernel)),
        None if pk is None else torch.from_numpy(pk).to(tdt), out_dtype=tdt)
    j, t = (j, t) if pk is not None else ((j,), (t,))
    for a, b in zip(j, t):
        assert b.dtype == tdt and tuple(b.shape) == a.shape
    return ([np.asarray(a.astype(jnp.float32)) for a in j],
            [b.float().numpy() for b in t])


@pytest.mark.parametrize("hf_odd", [False, True], ids=["He", "Ho"])
@pytest.mark.parametrize("wf_odd", [False, True], ids=["We", "Wo"])
def test_parity_grid_matches_jax(hf_odd, wf_odd):
    hc, wc = 5, 7
    want, got = _both(_mk(hc, wc, 2 * hc - hf_odd, 2 * wc - wf_odd, 8, 4, 4,
                          seed=hf_odd * 2 + wf_odd))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cu,cs,co,proj", [(64, 32, 32, True), (128, 64, 64, False)],
                         ids=["dec3-ratio-proj", "dec2-ratio"])
def test_model_channel_ratios_match_jax(cu, cs, co, proj):
    # dec3: even/even fine with the fused projection; dec2: odd W
    hc, wc = 4, 5
    want, got = _both(_mk(hc, wc, 2 * hc, 2 * wc - (cu == 128), cu, cs, co, seed=7, l=2,
                          proj=proj))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_bf16_with_projection_matches_jax():
    want, got = _both(_mk(5, 6, 9, 11, 16, 8, 8, seed=3, proj=True),
                      jnp.bfloat16, torch.bfloat16)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0.05, atol=0.05)


def test_rejects_wide_co_as_jax():
    coarse, skip, kernel, _ = _mk(4, 4, 8, 8, 8, 8, 65)
    with pytest.raises(AssertionError, match="Co <= 64"):
        jax_fused(jnp.asarray(coarse), jnp.asarray(skip), jnp.asarray(kernel))
    with pytest.raises(AssertionError, match="Co <= 64"):
        decoder.fused_up_concat_conv(torch.from_numpy(coarse), torch.from_numpy(skip),
                                     torch.from_numpy(kernel))
    pk = np.zeros((1, 1, 1, 16, 40), np.float32)
    with pytest.raises(AssertionError, match="Co <= 32"):
        decoder.fused_up_concat_conv(torch.from_numpy(coarse), torch.from_numpy(skip),
                                     torch.from_numpy(kernel[..., :40]), torch.from_numpy(pk))


def test_off_cpu_never_takes_the_twin():
    x = torch.empty((1, 2, 4, 5, 24), device="meta")
    kf = torch.empty((2, 3, 2, 3, 24, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        decoder.fused_conv_even(x, kf, torch.float32)
