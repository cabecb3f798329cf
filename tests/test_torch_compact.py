"""K2 (compact_rows, algo="place"), K2w (compact_rows, algo="window", the
default) and K3 (merge_sorted_rows): the port's plain twins are
byte-identical to the JAX Pallas kernels (interpret mode on the CPU), with
binding caps and payloads. The CUDA kernels are held against the twins in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import compact_pallas as jax_compact
from v2ce_toolbox_tpu_torch.ops import compact

INVALID = compact.INVALID


def _rows(seed, r, n, density):
    rng = np.random.RandomState(seed)
    keys = np.where(rng.rand(r, n) < density,
                    rng.randint(0, 1 << 30, (r, n)), INVALID).astype(np.int32)
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, (r, n)).astype(np.int32)
    return keys, pay


def _assert_same(jax_out, port_out):
    jk, jp, jkept, jtot = jax_out
    pk, pp, pkept, ptot = port_out
    np.testing.assert_array_equal(np.asarray(jk), pk.numpy())
    assert len(jp) == len(pp)
    for a, b in zip(jp, pp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jkept), pkept.numpy())
    np.testing.assert_array_equal(np.asarray(jtot), ptot.numpy())


@pytest.mark.parametrize("case", [
    # (rows, n, density, cap, chunk, payload): cap binds (1000 -> 1024 of
    # ~1229 valids) with a payload; cap free and n not a chunk multiple
    (8, 4096, 0.3, 1000, 512, True),
    (6, 1000, 0.5, 4096, 256, False),
])
def test_compact_rows_matches_jax(case):
    r, n, density, cap, chunk, with_pay = case
    keys, pay = _rows(1, r, n, density)
    pays = [pay] if with_pay else []
    ref = jax_compact.compact_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays],
                                   cap=cap, chunk=chunk, algo="place")
    got = compact.compact_rows(torch.from_numpy(keys),
                               [torch.from_numpy(p) for p in pays], cap=cap, chunk=chunk,
                               algo="place")
    _assert_same(ref, got)
    if cap < n:
        assert (got[3] > got[2]).any()      # the cap really binds


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 0.95, 1.0])
def test_compact_rows_window_matches_jax(density):
    # tests/test_compact.py's densities and shape: (4, 8 * 256), chunk 256,
    # cap 1024, one payload
    keys, pay = _rows(int(density * 100), 4, 8 * 256, density)
    pay = np.where(keys != INVALID, pay, 0)
    ref = jax_compact.compact_rows(jnp.asarray(keys), [jnp.asarray(pay)], cap=1024,
                                   chunk=256, algo="window")
    got = compact.compact_rows(torch.from_numpy(keys), [torch.from_numpy(pay)], cap=1024,
                               chunk=256)
    _assert_same(ref, got)


def test_compact_rows_window_capacity_drop_matches_jax():
    # tests/test_compact.py's drop case: fully dense rows, cap = 2 chunks
    keys = np.random.RandomState(7).randint(0, 1 << 20, (2, 8 * 256)).astype(np.int32)
    ref = jax_compact.compact_rows(jnp.asarray(keys), cap=512, chunk=256)
    got = compact.compact_rows(torch.from_numpy(keys), cap=512, chunk=256, algo="window")
    _assert_same(ref, got)
    assert (got[2] == 512).all() and (got[3] == 8 * 256).all()


def test_compact_rows_rejects_an_unknown_algo():
    keys = torch.full((1, 256), INVALID, dtype=torch.int32)
    with pytest.raises(ValueError, match="algo"):
        compact.compact_rows(keys, cap=256, chunk=256, algo="butterfly")


@pytest.mark.parametrize("case", [
    # (rows, width, nb, cap, payload): 4 groups whose totals pass the cap
    (16, 512, 4, 768, True),
    (6, 256, 6, 6 * 256, False),
])
def test_merge_sorted_rows_matches_jax(case):
    r, wd, nb, cap, with_pay = case
    keys, pay = _rows(2, r, wd, 0.6)
    keys = np.sort(keys, axis=1)             # valid prefix, INVALID tail
    pays = [pay] if with_pay else []
    ref = jax_compact.merge_sorted_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays],
                                        nb=nb, cap=cap)
    got = compact.merge_sorted_rows(torch.from_numpy(keys),
                                    [torch.from_numpy(p) for p in pays], nb=nb, cap=cap)
    _assert_same(ref, got)
