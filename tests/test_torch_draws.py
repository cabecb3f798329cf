"""Production draws of the port against the JAX package's: the port seeds
a torch.Generator per (run seed, chunk, slot) and JAX uses threefry keys,
so the two streams agree in distribution only. On the same voxels, per
strategy: the per-frame event counts and drops exactly equal, and the
timestamp distributions within KS 0.02 (the gate of
tests/test_model_rewrites.py::test_bf16_fidelity_metrics). 'none' draws
nothing, so its streams are identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.ops.ldati import sample_events as jax_sample_events
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _valid_ts(t_us, count):
    t = np.asarray(t_us)
    m = np.arange(t.shape[1])[None, :] < np.asarray(count)[:, None]
    return np.sort(t[m].astype(np.float64))


def ks_statistic(a, b):
    grid = np.union1d(a, b)
    return float(np.abs(np.searchsorted(a, grid, side="right") / len(a)
                        - np.searchsorted(b, grid, side="right") / len(b)).max())


@pytest.mark.parametrize("strategy", ["slope", "random", "none"])
def test_production_draws_match_jax_in_distribution(strategy):
    rng = np.random.RandomState(8)
    v = (rng.rand(2, 2, 10, 16, 48) * 3.0).astype(np.float32)
    settings = dict(additional_events_strategy=strategy, event_capacity=1 << 17)
    ref = jax_sample_events(jnp.asarray(v), jax.random.key(0),
                            **JaxSamplerConfig(**settings).sample_kwargs(fps=30))
    got = ldati.sample_events(torch.from_numpy(v), ldati.make_draw(0, 0, "cpu"),
                              SamplerConfig(**settings))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))
    a, b = _valid_ts(ref.t_us, ref.count), _valid_ts(got.t_us, got.count)
    ks = ks_statistic(a, b)
    if strategy == "none":                  # chain events only: no draws
        assert len(a) > 0 and ks == 0.0
    else:
        assert len(a) > 20000
    assert ks <= 0.02, ks
