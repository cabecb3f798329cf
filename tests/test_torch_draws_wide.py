"""Production draws of the port against the JAX package's on a grid wider
than 128 (2 x 16 x 160 voxels a frame) where the per-(frame, bin) chain
cap `cap_bin` and the multi-event pool `multi_cap` bind. There the JAX
fused `gen_compact` drops other chunks than the unfused chain (ROADMAP R3),
so JAX runs with use_gen_compact=False, the chain the port's K1 keeps.
The streams agree in distribution only (torch.Generator draws against
threefry): per-frame event counts and drops exactly equal, timestamps
within KS 0.02, as tests/test_torch_draws.py holds them on a narrow grid."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.ops.ldati import sample_events as jax_sample_events
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati

from tests.test_torch_draws import _valid_ts, ks_statistic
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("strategy", ["slope", "random"])
def test_wide_grid_with_binding_caps_matches_jax_in_distribution(strategy):
    rng = np.random.RandomState(12)
    v = (rng.rand(2, 2, 10, 16, 160) * 4.0).astype(np.float32)
    settings = dict(additional_events_strategy=strategy, event_capacity=1 << 17,
                    cap_bin=2048, multi_cap=512)
    ref = jax_sample_events(jnp.asarray(v), jax.random.key(0),
                            **JaxSamplerConfig(use_gen_compact=False,
                                               **settings).sample_kwargs(fps=30))
    got = ldati.sample_events(torch.from_numpy(v), ldati.make_draw(0, 0, "cpu"),
                              SamplerConfig(**settings))
    count, dropped = got.count.numpy(), got.dropped.numpy()
    # the caps bind in every frame (~50,000 of ~100,000 events dropped), and
    # only they: every frame's total stays under event_capacity
    assert (dropped > 0).all() and (count + dropped < settings["event_capacity"]).all()
    np.testing.assert_array_equal(count, np.asarray(ref.count))
    np.testing.assert_array_equal(dropped, np.asarray(ref.dropped))
    a, b = _valid_ts(ref.t_us, ref.count), _valid_ts(got.t_us, got.count)
    assert len(a) > 20000
    ks = ks_statistic(a, b)
    assert ks <= 0.02, ks
