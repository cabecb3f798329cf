"""K2 (compact_rows) and K3 (merge_sorted_rows): the port's plain twins are
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
                               [torch.from_numpy(p) for p in pays], cap=cap, chunk=chunk)
    _assert_same(ref, got)
    if cap < n:
        assert (got[3] > got[2]).any()      # the cap really binds


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
