"""The port's ablation samplers (`v2ce_toolbox_tpu_torch/ops/samplers.py`)
against the JAX package's, given the same voxels and draws: the Bernoulli
draw folds 10_001 into the chunk key over the whole (B*P, C, H, W) grid,
the compaction draws per frame (`tests/test_torch_ldati_v2.frame_draw`).
Streams must be byte-identical. Then the port's counterparts of the cases
of `tests/test_samplers.py` that need no reference checkout, on the
port's own production draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import samplers as js
from v2ce_toolbox_tpu_torch.events import to_recarrays
from v2ce_toolbox_tpu_torch.ops import samplers
from v2ce_toolbox_tpu_torch.ops.ldati import make_draw

from tests.test_torch_ldati_v2 import assert_streams_equal, frame_draw, sparse_voxels
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(capacity=1 << 13, max_events_per_voxel=8)


def sampler_draw(key, frames):
    """The JAX samplers' draws as the port's provider."""
    per_frame = frame_draw(key, frames)

    def draw(j, shape):
        if j == samplers.BERNOULLI:
            return torch.from_numpy(np.array(
                jax.random.uniform(jax.random.fold_in(key, j), shape)))
        return per_frame(j, shape)

    return draw


@pytest.mark.parametrize("name", ["random", "even", "slope"])
def test_samplers_match_jax(name):
    # 2x2x10x32x32, a block pool of 512 that binds and mepv 4 that caps
    v = sparse_voxels((2, 2, 10, 32, 32), seed=2, scale=4.0)
    key = jax.random.key(2)
    kw = dict(max_events_per_voxel=4, max_multi_voxels=512, capacity=1 << 14)
    if name == "slope":
        ref = js.sample_events_pure_slope(jnp.asarray(v), key, **kw)
        got = samplers.sample_events_pure_slope(torch.from_numpy(v), sampler_draw(key, 2), **kw)
    else:
        ref = js.sample_events_baseline(jnp.asarray(v), key, mode=name, **kw)
        got = samplers.sample_events_baseline(torch.from_numpy(v), sampler_draw(key, 2),
                                              mode=name, **kw)
    assert_streams_equal(ref, got)
    assert int(got.count.min()) > 0 and int(got.dropped.min()) > 0


@pytest.mark.parametrize("mode", ["random", "even"])
def test_baseline_counts_bounded_by_voxel(mode):
    # each voxel emits floor(y) or floor(y) + 1 events
    rng = np.random.RandomState(3)
    y = (rng.rand(1, 2, 10, 8, 9) * 3 * (rng.rand(1, 2, 10, 8, 9) < 0.5)).astype(np.float32)
    stream = samplers.sample_events_baseline(torch.from_numpy(y), make_draw(0, 0, "cpu"),
                                             mode=mode, **SMALL)
    n = int(stream.count[0])
    assert int(stream.dropped[0]) == 0
    assert np.floor(y).sum() <= n <= np.ceil(y).sum()
    t = stream.t_us[0, :n].numpy()
    x, yy, p = (a[0, :n].numpy() for a in (stream.x, stream.y, stream.p))
    c = 10
    # +1 µs: an event at a bin start truncates to floor(k * 3333.33) µs
    bins = np.clip(((t + 1) * 30 * c / 1e6).astype(int), 0, c - 1)
    grid = np.zeros((2, c, 8, 9), np.int64)
    np.add.at(grid, (1 - p, bins, yy, x), 1)       # polarity 1 = ON = P index 0
    assert np.all(grid >= np.floor(y[0])) and np.all(grid <= np.floor(y[0]) + 1)


def test_pure_slope_counts_and_fold():
    rng = np.random.RandomState(5)
    y = (rng.rand(1, 2, 10, 8, 9) * 2).astype(np.float32)
    folded = y.copy()
    folded[:, :, 8] += folded[:, :, 9]
    folded[:, :, 9] = 0
    stream = samplers.sample_events_pure_slope(torch.from_numpy(y), make_draw(1, 0, "cpu"),
                                               **SMALL)
    n = int(stream.count[0])
    assert np.floor(folded).sum() <= n <= np.ceil(folded).sum()
    t = stream.t_us[0, :n].numpy()
    assert np.all(np.diff(t) >= 0)
    bins = (t / (1e6 / 30 / 10)).astype(int)
    assert (bins >= 9).mean() < 0.01           # the emptied last bin, but for slope spill


def test_random_mode_uniform_in_bin():
    y = np.full((1, 2, 10, 16, 16), 2.0, np.float32)
    stream = samplers.sample_events_baseline(torch.from_numpy(y), make_draw(2, 0, "cpu"),
                                             mode="random", capacity=1 << 15,
                                             max_events_per_voxel=8)
    n = int(stream.count[0])
    delta_us = 1e6 / 30 / 10
    sub = stream.t_us[0, :n].numpy() % delta_us
    assert n == 2 * 10 * 16 * 16 * 2
    assert abs(sub.mean() - delta_us / 2) < 0.03 * delta_us


def test_host_wrappers():
    y = sparse_voxels((2, 2, 10, 8, 8), seed=4)
    draw = make_draw(3, 0, "cpu")
    for recs, stream in [
            (samplers.sample_voxel_baseline(y, even=True, draw=draw, device="cpu", **SMALL),
             samplers.sample_events_baseline(torch.from_numpy(y), draw, mode="even", **SMALL)),
            (samplers.sample_voxel_pure_slope(y, draw=draw, device="cpu", **SMALL),
             samplers.sample_events_pure_slope(torch.from_numpy(y), draw, **SMALL))]:
        assert len(recs) == 2
        for a, b in zip(recs, to_recarrays(stream)):
            assert a.tobytes() == b.tobytes() and len(a) > 0
    with pytest.raises(ValueError):
        samplers.sample_voxel_baseline(y, device="cpu")
