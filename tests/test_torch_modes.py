"""The port's sampler against JAX `sample_events` in the modes beyond the
default: strategy 'none' (K1's 'none' mode), 'random' (the two-word sort),
'slope' with max_events_per_voxel = 1 (the grid path's slot-0 draw before
compaction) and use_gen_compact=False (K4 then K2). Same voxels, same
uniform draws (the provider returns `jax.random.uniform(fold_in(key, j),
shape)`): the rows (`return_rows=True`: rows, voxel ids, emit and drop
totals) and the EventStream byte-identical. The EventStreams of 'random'
and of use_gen_compact=False are held in tests/test_torch_stream.py and
tests/test_torch_wide.py.
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
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(event_capacity=1 << 12, cap_bin=1 << 9, multi_cap=512, sort_cap=1 << 9)


def jax_kwargs(cfg: SamplerConfig) -> dict:
    return dict(fps=cfg.fps, additional_events_strategy=cfg.additional_events_strategy,
                pooling_type=cfg.pooling_type, pooling_kernel_size=cfg.pooling_kernel_size,
                bidirectional=cfg.bidirectional,
                max_events_per_voxel=cfg.max_events_per_voxel,
                capacity=cfg.event_capacity, cap_bin=cfg.cap_bin, multi_cap=cfg.multi_cap,
                sort_cap=cfg.sort_cap, use_gen_compact=cfg.use_gen_compact)


def voxels():
    rng = np.random.RandomState(0)
    return ((rng.rand(2, 2, 10, 16, 24) < 0.3) * rng.rand(2, 2, 10, 16, 24) * 5
            ).astype(np.float32)


def assert_streams_equal(ref, got):
    for name in ("t_us", "x", "y", "p", "count", "dropped"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def jax_draw(key):
    def draw(j, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, j), shape)))
    return draw


@pytest.mark.parametrize("mode", [dict(additional_events_strategy="none"),
                                  dict(additional_events_strategy="random"),
                                  dict(max_events_per_voxel=1),
                                  dict(use_gen_compact=False)],
                         ids=["none", "random", "mepv1", "gen_pack"])
def test_sample_rows_matches_jax(mode):
    v = voxels()
    cfg = SamplerConfig(**CAPS, **mode)
    key = jax.random.key(3)
    ref = sample_events(jnp.asarray(v), key, return_rows=True, **jax_kwargs(cfg))
    got = ldati.sample_rows(torch.from_numpy(v), jax_draw(key), cfg)
    for name, a, b in zip(("rel", "vox", "emit", "drop"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int((got[0] != INVALID).sum()) > 0


@pytest.mark.parametrize("mode", [dict(additional_events_strategy="none"),
                                  dict(max_events_per_voxel=1)], ids=["none", "mepv1"])
def test_sample_events_matches_jax(mode):
    v = voxels()
    cfg = SamplerConfig(**CAPS, **mode)
    key = jax.random.key(3)
    ref = sample_events(jnp.asarray(v), key, **jax_kwargs(cfg))
    got = ldati.sample_events(torch.from_numpy(v), jax_draw(key), cfg)
    assert_streams_equal(ref, got)
    assert int(got.count.sum()) > 0
