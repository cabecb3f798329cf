"""K8's plain twin (`v2ce_toolbox_tpu_torch/ops/correlation.py`) against the
JAX package's cost volume on the same numpy features: the Pallas kernel in
interpret mode (as `tests/test_correlation.py` runs it) within 1e-6 of the
largest |output|, and `correlation_jnp` within 1e-5 (`jnp.mean` divides
where the kernel multiplies by 1/C, and the sums run in other orders).
The port works in NCHW, the JAX package in NHWC."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.correlation import correlation as jax_correlation
from v2ce_toolbox_tpu.ops.correlation import correlation_jnp
from v2ce_toolbox_tpu_torch.ops.correlation import _correlation_torch, correlation


def _features(seed, c, n=2, h=12, w=20):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            rng.randn(n, h, w, c).astype(np.float32))


def _port(f1, f2, md):
    nchw = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in (f1, f2)]
    out = correlation(*nchw, max_displacement=md)             # a CPU tensor: the twin
    return np.moveaxis(out.numpy(), 1, -1)


def _assert_close(got, want, tol):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("md", [2, 3, 4])
@pytest.mark.parametrize("c", [16, 32, 64])
def test_twin_matches_jnp(md, c):
    f1, f2 = _features(md * 100 + c, c)
    want = np.asarray(correlation_jnp(jnp.asarray(f1), jnp.asarray(f2), max_displacement=md))
    _assert_close(_port(f1, f2, md), want, 1e-5)


@pytest.mark.parametrize("md,c", [(2, 16), (3, 32), (4, 64)])
def test_twin_matches_pallas_interpret(md, c):
    f1, f2 = _features(md * 10 + c, c)
    want = np.asarray(jax_correlation(jnp.asarray(f1), jnp.asarray(f2), max_displacement=md,
                                      interpret=True))
    _assert_close(_port(f1, f2, md), want, 1e-6)


def test_twin_edges_are_zero_padded():
    """A tap reaching past the plane reads zeros: with all-ones features
    each output counts the taps inside the plane, / 1."""
    f = torch.ones((1, 4, 5, 7))
    out = _correlation_torch(f, f, max_displacement=4)
    assert out.shape == (1, 81, 5, 7)
    assert float(out[0, 40].min()) == 1.0                      # the centre tap
    assert float(out[0, 0, 0, 0]) == 0.0                       # (-4, -4) from a corner
    assert float(out[0, 0, 4, 4]) == 1.0                       # ... lands at (0, 0)
