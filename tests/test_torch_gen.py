"""K1 (gen_compact): the port's plain twin against the JAX Pallas kernels.

For W <= 128 the TPU kernel's processing order is the canonical one, so
the twin must equal `gen_pallas.gen_compact` byte for byte, here with a
small chunk so that mid-stream emits, multi-pops and the cap_chunks
overflow all run. For W > 128 with binding caps the port keeps the
canonical order of the unfused chain, `compact_rows(gen_pack(...))`.
Emit and drop totals are exact in both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import compact_pallas, gen_pallas
from v2ce_toolbox_tpu_torch.ops import gen
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _grid(seed, f, h, w, density, scale):
    rng = np.random.RandomState(seed)
    v = (rng.rand(f, 2, 10, h, w) < density) * rng.rand(f, 2, 10, h, w) * scale
    return v.astype(np.float32)


def _vox_bits(v):
    _, p, _, h, w = v.shape
    return int(np.ceil(np.log2(p * h * w)))


def _assert_outputs_equal(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"output {i}")


@pytest.mark.parametrize("f,h,w", [
    # caps bind; then H*W % 4 != 0 in one partial tile of the CUDA kernel
    (1, 8, 24),
    (1, 5, 7),
])
def test_twin_equals_gen_compact_narrow(f, h, w):
    v = _grid(0, f, h, w, 0.9, 3.0)
    kw = dict(fps=30, mepv=8, vox_bits=_vox_bits(v), cap_bin=128, chunk=128)
    ref = gen_pallas.gen_compact(jnp.asarray(v), t0=0.0, strategy="slope", **kw)
    got = gen.gen_compact(torch.from_numpy(v), **kw)
    _assert_outputs_equal(ref, got)
    kept, total = got[2], got[3]
    if h * w > 100:                                          # caps bind
        assert (total > kept).any() and (total > 2 * 128).any()


@pytest.mark.parametrize("f,h,w,cap", [
    # W > 128 with a binding cap; then the CUDA kernel's tiling (1,024
    # pixels a tile): H*W % 4 != 0 over three tiles, the last partial; H*W
    # % 4 == 0 with a partial last tile; a cap on the 4,096-slot fill chunk
    (2, 8, 160, 512),
    (2, 23, 47, 512),
    (2, 20, 30, 4096),
])
def test_twin_equals_unfused_chain_wide(f, h, w, cap):
    v = _grid(1, f, h, w, 0.5, 8.0)
    vb = _vox_bits(v)
    keys, kx, emit, drop = gen_pallas.gen_pack(
        jnp.asarray(v), fps=30, t0=0.0, strategy="slope", mepv=8, vox_bits=vb)
    f, _, c, h, w = v.shape
    seg = 2 * h * w
    ck, (ckx,), kept, total = compact_pallas.compact_rows(
        keys.reshape(f * (c - 1), seg), [kx.reshape(f * (c - 1), seg)],
        cap=cap, chunk=512, algo="place")
    got = gen.gen_compact(torch.from_numpy(v), fps=30, mepv=8, vox_bits=vb,
                          cap_bin=cap, chunk=512)
    _assert_outputs_equal((ck, ckx, kept, total, emit, drop), got)
    if cap < 4096:
        assert (got[3] > got[2]).any()                    # cap_bin binds


@pytest.mark.parametrize("frames,seg,capp,expect", [
    # the main-path chunk (24 frames of 2 x 260 x 346, cap 16,384), the
    # pano strip width, a partial last tile, an empty frame
    (24, 179920, 16384, (176, 4, 1 + 24 * 176 * 11)),
    (24, 312000, 16384, (305, 4, 1 + 24 * 305 * 11)),
    (2, 2162, 512, (3, 1, 67)),
    (1, 0, 128, (0, 1, 1)),
])
def test_gen_compact_plan(frames, seg, capp, expect):
    # K1's tiling: compute tiles a frame, fill tiles a row, scratch words
    assert gen.plan(frames, seg, capp) == expect


def test_negative_voxels_emit_nothing_extra():
    rng = np.random.RandomState(9)
    v = (rng.randn(2, 2, 10, 4, 8) * 2.0).astype(np.float32)
    keys, kx, kept, total, emit, drop = gen.gen_compact(
        torch.from_numpy(v), fps=30, mepv=4, vox_bits=_vox_bits(v), cap_bin=128, chunk=128)
    pk, pkx, pemit, pdrop = gen.gen_pack_torch(torch.from_numpy(v), fps=30, mepv=4,
                                               vox_bits=_vox_bits(v))
    assert torch.equal(total, (pk != gen.INVALID).sum(1, dtype=torch.int32))
    assert torch.equal(emit, pemit) and torch.equal(drop, pdrop)
    assert int(emit.sum()) >= int(total.sum())
