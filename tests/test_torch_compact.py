"""K2 (compact_rows, algo="place"), K2w (compact_rows, algo="window", the
default) and K3 (merge_sorted_rows): the port's plain twins are
byte-identical to the JAX Pallas kernels (interpret mode on the CPU), with
binding caps and payloads, and for K2w at row lengths that are not a
multiple of the chunk, which the JAX wrapper pads and the port does not.
The launch plan and its constants are the kernels'. The CUDA kernels are
held against the twins in tests/test_torch_kernels.py."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import compact_pallas as jax_compact
from v2ce_toolbox_tpu_torch.ops import _cuda, compact
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

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


def _offset_view(a):
    """a as a contiguous view whose data starts one int32 into its buffer
    (not on 16 bytes), as `side_in[None]`-style views can."""
    flat = torch.from_numpy(np.concatenate([np.zeros(1, a.dtype), a.ravel()]))
    return flat[1:].view(a.shape)


@pytest.mark.parametrize("case", [
    # (rows, n, density, cap, chunk, payload, view): cap binds (1000 -> 1024
    # of ~1229 valids) with a payload; cap free and n not a chunk multiple;
    # then the shapes the CUDA kernel's paths split on (4,096-key tiles):
    # n % 4 != 0 (key-by-key loads), an offset view, one row of many tiles
    # (a long look-back), all-valid rows whose cap falls on a tile boundary,
    # all-INVALID rows
    (8, 4096, 0.3, 1000, 512, True, False),
    (6, 1000, 0.5, 4096, 256, False, False),
    (2, 16387, 0.5, 4096, 4096, True, False),
    (2, 16384, 0.5, 4096, 4096, True, True),
    (1, 8192 * 9 + 5, 0.3, 16384, 16384, True, False),
    (2, 24576, 1.0, 8192, 8192, True, False),
    (3, 9000, 0.0, 4096, 512, True, False),
])
def test_compact_rows_matches_jax(case):
    r, n, density, cap, chunk, with_pay, view = case
    keys, pay = _rows(1, r, n, density)
    pays = [pay] if with_pay else []
    ref = jax_compact.compact_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays],
                                   cap=cap, chunk=chunk, algo="place")
    as_torch = _offset_view if view else torch.from_numpy
    got = compact.compact_rows(as_torch(keys), [as_torch(p) for p in pays], cap=cap,
                               chunk=chunk, algo="place")
    _assert_same(ref, got)
    if cap < n and density > 0:
        assert (got[3] > got[2]).any()      # the cap really binds


@pytest.mark.parametrize("rows,n,capp,expect", [
    # the three main-path calls of a 24-frame chunk, the grid-width call,
    # the EventStream side list, an empty row and a zero cap
    (216, 16384, 4096, (4, 1, 865)),
    (216, 31616, 16384, (8, 1, 1729)),
    (216, 179920, 16384, (44, 1, 9505)),
    (1, 24 * 147456, 122880, (864, 8, 865)),
    (3, 0, 128, (0, 1, 1)),
    (2, 4096, 0, (1, 1, 3)),
    (2, 4097, 16385, (2, 2, 5)),
])
def test_compact_plan(rows, n, capp, expect):
    # K2's tiling: compute tiles a row, fill tiles a row, scratch words
    assert compact.plan(rows, n, capp) == expect


@pytest.mark.parametrize("rows,n,capp,expect", [
    # K2w's tiles of 8,192 keys: the probe rows (144 x 182,272 keys, cap
    # 16,384 and 65,536), a row shorter than a tile, an empty row, a row of
    # 301 tiles
    (144, 182272, 16384, (23, 1, 3313)),
    (144, 182272, 65536, (23, 4, 3313)),
    (5, 1000, 256, (1, 1, 6)),
    (4, 0, 256, (0, 1, 1)),
    (1, 4096 * 600 + 12, 1 << 20, (301, 64, 302)),
])
def test_compact_window_plan(rows, n, capp, expect):
    assert compact.plan(rows, n, capp, compact._WINDOW_TILE) == expect


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


@pytest.mark.parametrize("case", [
    # (rows, n, density, cap, payload, empty row), chunk 256, n not a
    # multiple of it (the JAX wrapper pads, the port does not): the cap
    # binding inside a chunk (300 -> 512 of ~800 valids) with a payload;
    # n % 4 != 0 (the kernel's key-by-key route); n smaller than one chunk;
    # an all-INVALID row beside others
    (3, 1000, 0.8, 300, True, False),
    (2, 1001, 0.5, 1024, True, False),
    (2, 200, 0.5, 256, True, False),
    (3, 777, 0.4, 256, False, True),
])
def test_compact_rows_window_ragged_n_matches_jax(case):
    r, n, density, cap, with_pay, empty_row = case
    keys, pay = _rows(11, r, n, density)
    if empty_row:
        keys[1] = INVALID
    pays = [np.where(keys != INVALID, pay, 0)] if with_pay else []
    ref = jax_compact.compact_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays],
                                   cap=cap, chunk=256, algo="window")
    got = compact.compact_rows(torch.from_numpy(keys), [torch.from_numpy(p) for p in pays],
                               cap=cap, chunk=256, algo="window")
    _assert_same(ref, got)
    if cap < n * density:
        assert (got[3] > got[2]).any()      # the cap really binds
    if empty_row:
        assert int(got[3][1]) == 0


def test_compact_plan_constants_match_the_kernel():
    # the tiles and the fill chunk the plan assumes are the kernel's own
    with open(os.path.join(_cuda._CSRC, "compact_rows.cu")) as fh:
        src = fh.read()
    consts = {m.group(1): m.group(2) for m in
              re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(consts["kThreads"]) * int(consts["kSteps"]) == compact._TILE
    assert consts["kTile"] == "kThreads * kSteps"
    assert int(consts["kThreads"]) * int(consts["kWindowSteps"]) == compact._WINDOW_TILE
    assert consts["kWindowTile"] == "kThreads * kWindowSteps"
    assert int(consts["kFill"]) == compact._FILL


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
