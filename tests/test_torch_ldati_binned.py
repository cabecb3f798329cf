"""The port's binned v2 compaction (`ops/ldati.compact_frame_events_binned`)
and `compact_dispatch` against the JAX package's (`ldati.py:320-514`), and
`sample_events(use_v3=False)` against the JAX keyword, given the same
inputs and the same uniform draws.

The JAX functions run one frame at a time under the frame's key of
`split(key, frames)`; `frame_draw` feeds the port those draws. The
timestamp rules handed to both compactions are integer-exact (a truncated
f32 product plus integer µs), so the comparison holds the compaction
itself, and jitting the JAX frame (one compile a case, a third of the
eager calls' per-primitive compiles) cannot change a bit; the strategies'
float rules are held on the flat route by `tests/test_torch_ldati_v2.py`.
Outputs must be byte-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import ldati as jl
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from tests.test_torch_ldati_v2 import assert_streams_equal, frame_draw, sparse_voxels
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

CB, FPS, FRAMES = 9, 30, 3
STEP_US = 1e6 / FPS / CB                    # a 30 fps bin, 3703.7 µs
OUT = ("t_us", "vox_id", "count", "dropped")


def frame_inputs(p, h, w, seed, max_emit):
    """(frames, cb*seg) emit counts in 0 .. max_emit, about half of them 0,
    the chain µs of each voxel (a few below its bin start and past the
    packed key's reach, so both clips act) and the (cb,) bin starts."""
    seg = p * h * w
    rng = np.random.RandomState(seed)
    emit = (rng.randint(1, max_emit + 1, (FRAMES, CB * seg))
            * (rng.rand(FRAMES, CB * seg) < 0.55)).astype(np.int32)
    bin_us = (np.arange(CB, dtype=np.float32) * np.float32(STEP_US / 1e6)
              * np.float32(1e6)).astype(np.int32)
    vox_bin = np.repeat(np.arange(CB), seg)
    chain = (bin_us[vox_bin] + rng.randint(-300, 4400, (FRAMES, CB * seg))).astype(np.int32)
    return emit, chain, bin_us


def jax_ts_fn(strategy, chain, is_chain, bin_us, seg, span):
    """One frame's rule: 'none' the chain µs; 'slope' the chain µs of a
    count-1 voxel, else the bin start plus trunc(u * span)."""
    vox_bin_us = jnp.repeat(jnp.asarray(bin_us), seg)

    def ts_fn(j, u, vox):
        if strategy == "none":
            return chain if vox is None else chain[vox]
        if vox is None:
            return jnp.where(is_chain, chain, vox_bin_us + (u * span).astype(jnp.int32))
        return vox_bin_us[vox] + (u * span).astype(jnp.int32)

    return ts_fn


def torch_ts_fn(strategy, chain, is_chain, bin_us, seg, span):
    """`jax_ts_fn` for (frames, n) tensors."""
    vox_bin_us = torch.from_numpy(np.repeat(bin_us, seg))[None].expand(chain.shape[0], -1)
    span = ldati.f32(span, "cpu")

    def ts_fn(j, u, vox):
        if strategy == "none":
            return chain if vox is None else ldati._gather(chain, vox)
        if vox is None:
            return torch.where(is_chain, chain, vox_bin_us + (u * span).to(torch.int32))
        return ldati._gather(vox_bin_us, vox) + (u * span).to(torch.int32)

    return ts_fn


def run_both(jax_fn, port_fn, strategy, p, h, w, seed, span, max_emit, **kw):
    """(JAX outputs stacked over frames, port outputs) of one compaction."""
    seg = p * h * w
    emit, chain, bin_us = frame_inputs(p, h, w, seed, max_emit)
    key = jax.random.key(seed)
    keys = jax.random.split(key, FRAMES)
    frame = jax.jit(lambda e, c, k: jax_fn(e, jax_ts_fn(strategy, c, e == 1, bin_us, seg, span),
                                           jnp.asarray(bin_us), k, **kw))
    ref = [frame(jnp.asarray(emit[f]), jnp.asarray(chain[f]), keys[f]) for f in range(FRAMES)]
    ref = [np.stack([np.asarray(r[i]) for r in ref]) for i in range(4)]
    got = port_fn(torch.from_numpy(emit),
                  torch_ts_fn(strategy, torch.from_numpy(chain), torch.from_numpy(emit == 1),
                              bin_us, seg, span),
                  torch.from_numpy(bin_us), frame_draw(key, FRAMES), **kw)
    return emit, chain, bin_us, key, ref, got


def assert_equal(ref, got):
    for name, a, b in zip(OUT, ref, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def _dispatch(binned):
    """compact_dispatch with the JAX argument order of the binned entry."""
    def jax_fn(emit, ts_fn, bin_us, key, **kw):
        return jl.compact_dispatch(emit, ts_fn, key, bin_start_us=bin_us, **kw,
                                   use_binned_compaction=binned)

    def port_fn(emit, ts_fn, bin_us, draw, **kw):
        return ldati.compact_dispatch(emit, ts_fn, draw, bin_start_us=bin_us, **kw,
                                      use_binned_compaction=binned)

    return jax_fn, port_fn


@pytest.mark.parametrize("case", ["slope", "none", "caps", "gate"])
def test_binned_compaction_matches_jax(case):
    if case in ("slope", "none"):
        # 2x8x12 voxels a bin (seg 192, 8 bits) and 12-bit sub-bin µs: the
        # gate passes; no cap binds, the bins' pools of 455 hold every multi
        mepv = 4 if case == "slope" else 1
        kw = dict(cb=CB, seg=192, max_rel_us=int(STEP_US) + 2, max_events_per_voxel=mepv,
                  max_multi_voxels=4096, capacity=4096)
        emit, _, _, _, ref, got = run_both(*_dispatch(True), case, 2, 8, 12, 7, STEP_US,
                                           mepv, **kw)
        assert_equal(ref, got)
        assert np.array_equal(got[2].numpy(), np.minimum(emit, mepv).sum(axis=1))
        assert int(got[3].sum()) == 0
    elif case == "caps":
        # three 80-key tiles a bin (the last padded), 40 slots a bin, 12
        # pool slots, 200 out: each binds
        kw = dict(cb=CB, seg=192, ts_bits=12, max_events_per_voxel=4, capacity=200, tile=80,
                  cap_bin=40, pool_bin=12)
        emit, chain, bin_us, key, ref, got = run_both(
            jl.compact_frame_events_binned, ldati.compact_frame_events_binned, "slope",
            2, 8, 12, 8, STEP_US, 4, **kw)
        assert_equal(ref, got)
        # slot-0 keys as the port packs them: each bin holds more than
        # cap_bin, and more than pool_bin multis among its first cap_bin
        u0 = frame_draw(key, FRAMES)(0, emit.shape).numpy()
        ts0 = np.where(emit == 1, chain, np.repeat(bin_us, 192)
                       + (u0 * np.float32(STEP_US)).astype(np.int32))
        rel = np.clip(ts0 - np.repeat(bin_us, 192), 0, (1 << 12) - 2)
        keys = np.where(emit > 0, (rel << 8) | np.tile(np.arange(192), CB),
                        ldati.INVALID).reshape(FRAMES, CB, 192)
        assert (emit.reshape(FRAMES, CB, 192) > 0).sum(axis=2).min() > 40
        first = np.sort(keys, axis=2)[:, :, :40]
        multi = np.take_along_axis(emit.reshape(FRAMES, CB, 192), first & 255, axis=2) >= 2
        assert multi.sum(axis=2).min() > 12
        assert np.array_equal(got[2].numpy(), [200] * FRAMES) and int(got[3].min()) > 0
    else:
        # 2x32x40 voxels a bin (seg 2560, 12 bits) under 'random's 1 s
        # reach (20 bits): 32 bits, so both send the call to the flat route
        kw = dict(cb=CB, seg=2560, max_rel_us=int(1e6), max_events_per_voxel=3,
                  max_multi_voxels=512, capacity=1 << 15)
        emit, chain, bin_us, key, ref, got = run_both(*_dispatch(True), "slope", 2, 32, 40,
                                                      9, 1e6, 3, **kw)
        assert_equal(ref, got)
        flat = ldati.compact_frame_events(
            torch.from_numpy(emit),
            torch_ts_fn("slope", torch.from_numpy(chain), torch.from_numpy(emit == 1), bin_us,
                        2560, 1e6),
            frame_draw(key, FRAMES), max_events_per_voxel=3, max_multi_voxels=512,
            capacity=1 << 15)
        for name, a, b in zip(OUT, flat, got):
            assert torch.equal(a, b), name


def test_sample_events_use_v3_false_matches_jax():
    # 30 fps at 2x16x20: the v3 gate passes, and use_v3=False sends both
    # packages to the v2 core; a block pool of 64 that binds
    assert ldati.supports_rows(2, 16, 20, fps=FPS)
    assert not ldati.supports_rows(2, 16, 20, fps=FPS, use_v3=False)
    v = sparse_voxels((2, 2, 10, 16, 20), seed=3)
    for strategy in ("slope", "none", "random"):
        key = jax.random.key(11)
        ref = jl.sample_events(jnp.asarray(v), key, fps=FPS, max_events_per_voxel=4,
                               max_multi_voxels=64, capacity=4096, use_v3=False,
                               additional_events_strategy=strategy)
        cfg = SamplerConfig(fps=FPS, max_events_per_voxel=4, event_capacity=4096,
                            additional_events_strategy=strategy)
        got = ldati.sample_events(torch.from_numpy(v), frame_draw(key, 2), cfg,
                                  max_multi_voxels=64, use_v3=False)
        assert_streams_equal(ref, got)
        assert got.t_us.shape == (2, 4096) and int(got.count.min()) > 0
        assert int(got.dropped.min()) > 0 or strategy == "none"
    with pytest.raises(ValueError, match="v3 sampler core"):
        ldati.sample_events(torch.from_numpy(v), frame_draw(key, 2), cfg, return_rows=True,
                            use_v3=False)
