"""The port's v2 sampler core against the JAX package's
(`v2ce_toolbox_tpu/ops/ldati.py:220-570` and the non-v3 tail of
`sample_events`), given the same voxels and the same uniform draws.

The v2 core draws per frame: the JAX chunk key is split into one key a
frame, and slot j of frame f draws `uniform(fold_in(keys[f], j), (n,))`.
The port's provider takes `draw(j, (frames, n))`; `frame_draw` feeds it
exactly those rows. Buffers, counts and drops must be byte-identical: the
(key, voxel) sort is stable in the port, and XLA:CPU kept the input order
on ties in every case here, so no comparison falls back to per-frame
multisets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import ldati as jl
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

FIELDS = ("t_us", "x", "y", "p", "count", "dropped")


def frame_draw(key, frames):
    """The JAX v2 core's draws as the port's provider: row f of draw(j,
    (frames, n)) is uniform(fold_in(split(key, frames)[f], j), (n,))."""
    keys = jax.random.split(key, frames)

    def draw(j, shape):
        assert shape[0] == frames, shape
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(jax.random.fold_in(keys[f], j), shape[1:]))
            for f in range(frames)]))

    return draw


def one_frame_draw(key):
    """Draws of one frame's JAX compaction under `key` (no split)."""
    def draw(j, shape):
        assert shape[0] == 1, shape
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, j), shape[1:]))[None])

    return draw


def assert_streams_equal(ref, got):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def sparse_voxels(shape, seed, density=0.5, scale=3.0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(*shape) < density) * rng.rand(*shape) * scale).astype(np.float32)


def _ts_ms(j, u, vox_idx):
    return (u * 1000).astype(jnp.int32)


def _ts_ms_torch(j, u, vox_idx):
    return (u * ldati.f32(1000.0, u.device)).to(torch.int32)


@pytest.mark.parametrize("capacity", [512, 300])
def test_compact_frame_events_block_pool(capacity):
    # tests/test_ldati.py:240-275: multis beyond the 16-voxel block pool and
    # beyond mepv, with the capacity binding or not
    emit = np.ones(256, np.int32)
    emit[48:64] = 5
    emit[48] = 20
    emit[112:128] = 3
    emit[180] = 2
    key = jax.random.key(0)
    ref = jl.compact_frame_events(jnp.asarray(emit), _ts_ms, key, max_events_per_voxel=4,
                                  max_multi_voxels=32, capacity=capacity)
    got = ldati.compact_frame_events(torch.from_numpy(emit)[None], _ts_ms_torch,
                                     one_frame_draw(key), max_events_per_voxel=4,
                                     max_multi_voxels=32, capacity=capacity)
    for name, a, b in zip(("t_us", "vox_id", "count", "dropped"), ref, got):
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a), err_msg=name)
    assert int(got[2][0]) == min(336, capacity) and int(got[3][0]) == 368 - int(got[2][0])


def test_compact_frame_events_top_k_pool_ties():
    # V = 250 is no multiple of 16: the plain top-k pool over voxels, whose
    # ties (many voxels share an extra count) lax.top_k breaks by index
    rng = np.random.RandomState(4)
    emit = rng.choice([0, 1, 2, 3, 3, 5], size=250).astype(np.int32)
    key = jax.random.key(9)
    ref = jl.compact_frame_events(jnp.asarray(emit), _ts_ms, key, max_events_per_voxel=5,
                                  max_multi_voxels=40, capacity=1024)
    got = ldati.compact_frame_events(torch.from_numpy(emit)[None], _ts_ms_torch,
                                     one_frame_draw(key), max_events_per_voxel=5,
                                     max_multi_voxels=40, capacity=1024)
    for name, a, b in zip(("t_us", "vox_id", "count", "dropped"), ref, got):
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a), err_msg=name)
    assert int(got[3][0]) > 0                      # the pool binds
    # the pool's order: extra descending, the lower voxel first on ties
    extra = torch.clamp(torch.from_numpy(emit)[None] - 1, min=0)
    idx = ldati._top_k_indices(extra, 40)[0].numpy()
    assert np.array_equal(idx, np.asarray(jax.lax.top_k(jnp.asarray(emit) - 1, 40)[1]))


@pytest.mark.parametrize("settings", [
    dict(additional_events_strategy="slope"), dict(additional_events_strategy="none"),
    dict(additional_events_strategy="random"), dict(pooling_type="avg"),
    dict(pooling_type="weighted"), dict(bidirectional=True)],
    ids=["slope", "none", "random", "avg", "weighted", "bidirectional"])
def test_sample_events_v2_matches_jax(settings):
    # 2x2x10x64x130 at 1 fps: the ids of 16,640 voxels a frame leave the
    # packed key too few bits for a 111,113 µs bin, so both packages take
    # the v2 core; a block pool of 512 that binds, and dense enough to
    # tell the FMA forms of the chain timestamp apart ('none' contracts
    # the bin start's product)
    assert not ldati.supports_rows(2, 64, 130, fps=1)
    v = sparse_voxels((2, 2, 10, 64, 130), seed=1)
    key = jax.random.key(5)
    kw = dict(max_events_per_voxel=4, max_multi_voxels=512, capacity=1 << 16)
    ref = jl.sample_events(jnp.asarray(v), key, fps=1, **kw, **settings)
    cfg = SamplerConfig(fps=1, max_events_per_voxel=4, event_capacity=1 << 16, **settings)
    got = ldati.sample_events(torch.from_numpy(v), frame_draw(key, 2), cfg,
                              max_multi_voxels=512)
    assert_streams_equal(ref, got)
    assert got.t_us.shape == (2, 1 << 16) and int(got.count.min()) > 0
    assert int(got.dropped.min()) > 0 or settings.get("additional_events_strategy") == "none"


def test_sample_events_gate_fails_at_fps_1():
    # 2x64x160 voxel ids need 15 bits, which leave 65,534 µs for the
    # sub-bin time; a 1 fps bin is 111,113 µs: the gate itself fails and
    # both packages take the v2 core
    assert not ldati.supports_rows(2, 64, 160, fps=1)
    v = sparse_voxels((2, 2, 10, 64, 160), seed=3, density=0.3)
    key = jax.random.key(7)
    kw = dict(max_events_per_voxel=4, max_multi_voxels=1024, capacity=1 << 16)
    ref = jl.sample_events(jnp.asarray(v), key, fps=1, **kw)
    cfg = SamplerConfig(fps=1, max_events_per_voxel=4, event_capacity=1 << 16)
    got = ldati.sample_events(torch.from_numpy(v), frame_draw(key, 2), cfg,
                              max_multi_voxels=1024)
    assert_streams_equal(ref, got)
    n = int(got.count[0])
    assert n > 0 and bool(torch.all(got.t_us[0, 1:n] >= got.t_us[0, :n - 1]))
    assert int(got.t_us[0, n - 1]) > 8 * 111_111       # the last bin is reached


def test_v2_rows_raise():
    v = torch.zeros((1, 2, 10, 64, 160))
    with pytest.raises(ValueError, match="v3"):
        ldati.sample_events(v, ldati.make_draw(0, 0, "cpu"), SamplerConfig(fps=1),
                            return_rows=True)
