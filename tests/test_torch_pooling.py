"""The port's sampler against JAX in the grid-path modes: 'slope' with 'avg'
and 'weighted' pooling, and bidirectional relocation. Same voxels, same
uniform draws: rows, voxel ids, emit and drop totals byte-identical, and
for the pooled modes the EventStream too (bidirectional's is held in
tests/test_torch_stream.py).

The grid path is where XLA:CPU's fusion decides the f32 roundings: the
port reproduces its multiply by the f32 reciprocal of a constant divisor,
the 1/9 of 'avg' folded into its two consumers as FMAs, and the
inverse-CDF discriminant contracted at b*b rather than at (2k)*u
(`ops/ldati.slope_params`, `inverse_cdf_ts`). The 3x3 pooling sums are
exact in any order on integer counts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.ldati import sample_events
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from v2ce_toolbox_tpu_torch.ops.compact import INVALID

from tests.test_torch_modes import CAPS, assert_streams_equal, jax_draw, jax_kwargs, voxels
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("mode", [dict(pooling_type="avg"), dict(pooling_type="weighted"),
                                  dict(bidirectional=True)],
                         ids=["avg", "weighted", "bidirectional"])
def test_grid_path_rows_match_jax(mode):
    v = voxels()
    cfg = SamplerConfig(**CAPS, **mode)
    key = jax.random.key(3)
    ref = sample_events(jnp.asarray(v), key, return_rows=True, **jax_kwargs(cfg))
    got = ldati.sample_rows(torch.from_numpy(v), jax_draw(key), cfg)
    for name, a, b in zip(("rel", "vox", "emit", "drop"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int((got[0] != INVALID).sum()) > 0


@pytest.mark.parametrize("pooling", ["avg", "weighted"])
def test_pooled_sample_events_match_jax(pooling):
    v = voxels()
    cfg = SamplerConfig(**CAPS, pooling_type=pooling)
    key = jax.random.key(3)
    ref = sample_events(jnp.asarray(v), key, **jax_kwargs(cfg))
    got = ldati.sample_events(torch.from_numpy(v), jax_draw(key), cfg)
    assert_streams_equal(ref, got)
    assert int(got.count.sum()) > 0


def test_pooling_sums_and_slope_match_jax():
    from v2ce_toolbox_tpu.ops import ldati as jax_ldati

    rng = np.random.RandomState(1)
    counts = rng.randint(-2, 12, size=(4, 9, 16, 24)).astype(np.float32)
    for pooling in ("avg", "weighted"):
        want = jax.jit(lambda c: jax_ldati._pool_counts(c, pooling, 3))(jnp.asarray(counts))
        got = ldati._pool_counts(torch.from_numpy(counts), pooling, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=pooling)
        wk, wb = jax.jit(lambda c: jax_ldati.slope_params(c, 30, pooling_type=pooling))(
            jnp.asarray(counts))
        gk, gb = ldati.slope_params(torch.from_numpy(counts), 30, pooling_type=pooling)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk), err_msg=pooling)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb), err_msg=pooling)
