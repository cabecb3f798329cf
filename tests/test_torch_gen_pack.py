"""K4 (gen_pack), K1's 'none' strategy and K5 (append_rows): the port's
plain twins against the JAX Pallas kernels (interpret mode on the CPU).

gen_pack writes the full candidate grid in the canonical voxel order at
any width, so its twin must equal it byte for byte. For W <= 128 the TPU
gen_compact processes candidates in that order too; for W > 128 its row
order is (polarity, w-block, h, w % 128), so there the twin equals the
unfused chain compact_rows(gen_pack(...)) byte for byte and gen_compact
row for row as sorted sets. append_rows is held with and without a
payload, with a binding cap. The CUDA kernels are held against the twins
in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import compact_pallas, gen_pallas
from v2ce_toolbox_tpu_torch.ops import compact, gen
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

INVALID = compact.INVALID


def _grid(seed, f, h, w, density, scale):
    rng = np.random.RandomState(seed)
    v = (rng.rand(f, 2, 10, h, w) < density) * rng.rand(f, 2, 10, h, w) * scale
    return v.astype(np.float32)


def _vox_bits(v):
    _, p, _, h, w = v.shape
    return int(np.ceil(np.log2(p * h * w)))


def _assert_equal(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        if a is None:
            assert b is None, f"output {i}"
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"output {i}")


@pytest.mark.parametrize("strategy", ["slope", "none"])
def test_gen_pack_twin_matches_jax(strategy):
    v = _grid(0, 2, 8, 150, 0.5, 6.0)
    f, p, c, h, w = v.shape
    kw = dict(fps=30, mepv=8, vox_bits=_vox_bits(v), strategy=strategy)
    keys, kx, emit, drop = gen_pallas.gen_pack(jnp.asarray(v), t0=0.0, **kw)
    ref = (np.asarray(keys).reshape(f * (c - 1), -1),
           None if kx is None else np.asarray(kx).reshape(f * (c - 1), -1), emit, drop)
    got = gen.gen_pack(torch.from_numpy(v), **kw)
    _assert_equal(ref, got)
    assert int((got[0] != INVALID).sum()) > 0 and int(got[2].sum()) > 0


def test_gen_compact_none_twin_narrow_matches_jax():
    v = _grid(1, 1, 8, 24, 0.6, 2.5)
    kw = dict(fps=30, mepv=8, vox_bits=_vox_bits(v), cap_bin=256, chunk=256)
    ref = gen_pallas.gen_compact(jnp.asarray(v), t0=0.0, strategy="none", **kw)
    got = gen.gen_compact(torch.from_numpy(v), strategy="none", **kw)
    _assert_equal(ref, got)
    assert got[1] is None and int(got[5].sum()) == 0
    assert int(got[2].sum()) > 0


def test_gen_compact_none_twin_wide_matches_jax():
    v = _grid(2, 1, 8, 140, 0.1, 2.5)
    f, p, c, h, w = v.shape
    vb = _vox_bits(v)
    keys, _, emit, drop = gen_pallas.gen_pack(jnp.asarray(v), fps=30, t0=0.0,
                                              strategy="none", mepv=8, vox_bits=vb)
    ck, _, kept, total = compact_pallas.compact_rows(
        keys.reshape(f * (c - 1), -1), [], cap=1024, chunk=1024, algo="place")
    got = gen.gen_compact(torch.from_numpy(v), fps=30, mepv=8, vox_bits=vb, cap_bin=1024,
                          chunk=1024, strategy="none")
    _assert_equal((ck, None, kept, total, emit, drop), got)
    # the TPU kernel's rows hold the same candidates in its tiling order
    tk, _, tkept, ttotal, temit, _ = gen_pallas.gen_compact(
        jnp.asarray(v), fps=30, t0=0.0, strategy="none", mepv=8, vox_bits=vb,
        cap_bin=1024, chunk=1024)
    assert int(np.asarray(ttotal).max()) <= 1024            # no cap binds
    np.testing.assert_array_equal(np.sort(np.asarray(tk), axis=1),
                                  np.sort(got[0].numpy(), axis=1))
    _assert_equal((tkept, ttotal, temit), got[2:5])


@pytest.mark.parametrize("with_pay,cap", [(True, 1000), (False, 4096)])
def test_append_rows_twin_matches_jax(with_pay, cap):
    rng = np.random.RandomState(7)
    r, n = 6, 700
    lengths = rng.randint(0, n + 1, r)
    lengths[2] = 0
    keys = np.where(np.arange(n)[None, :] < lengths[:, None],
                    rng.randint(0, 1 << 30, (r, n)), INVALID).astype(np.int32)
    pays = [rng.randint(-2 ** 31, 2 ** 31 - 1, (r, n)).astype(np.int32)] if with_pay else []
    ref = compact_pallas.append_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays],
                                     cap=cap, chunk=256)
    got = compact.append_rows(torch.from_numpy(keys), [torch.from_numpy(p) for p in pays],
                              cap=cap, chunk=256)
    jk, jp, jkept, jtot = ref
    pk, pp, pkept, ptot = got
    _assert_equal((jk, jkept, jtot, *jp), (pk, pkept, ptot, *pp))
    assert len(pp) == len(pays)
    if cap < lengths.sum():
        assert int(ptot[0]) > int(pkept[0]) == 1024          # the cap binds
