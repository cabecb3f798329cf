"""K3 (merge_sorted_rows) and K5 (append_rows) on the CPU: the launch plan
that the wrappers pass to csrc/merge_rows.cu (which checks it against its
own constants) at the main-path shapes of a 24-frame chunk and at the
edges, the wrappers' limits, and one K3 case against the JAX Pallas
kernel (interpret mode) with a binding cap and an empty row. K5's twin is
held against JAX with both in tests/test_torch_gen_pack.py; the CUDA
kernels are held against the twins in tests/test_torch_kernels.py."""

import os
import re

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.ops import _cuda, compact
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

INVALID = compact.INVALID


@pytest.mark.parametrize("rows,width,capp,expect", [
    # the main path: K3's one-word stream merge and side list (center CLI),
    # K3's per-frame merge of the EventStream route (ldati.py:546), K5's flatten
    (216, 16384, 216 * 16384, (4, 864, 865)),
    (216, 4096, 120832, (1, 30, 217)),
    (216, 16384, 147456, (4, 36, 865)),
    (24, 147456, 24 * 147456, (36, 864, 865)),
    # edges: a row narrower than a tile, a cap below one fill chunk, a zero
    # cap, no keys, a ragged last tile, a cap one past a fill chunk
    (3, 128, 256, (1, 1, 4)),
    (2, 8192, 1024, (2, 1, 5)),
    (2, 4096, 0, (1, 1, 3)),
    (4, 0, 128, (0, 1, 1)),
    (5, 5001, 8192, (2, 2, 11)),
    (1, 4096, 4097, (1, 2, 2)),
])
def test_merge_plan(rows, width, capp, expect):
    # compute tiles a row, fill tiles an output row, 64-bit scratch words
    assert compact.merge_plan(rows, width, capp) == expect


def test_merge_plan_constants_match_the_kernel():
    # the tile and fill chunk the plan assumes are the kernel's own
    with open(os.path.join(_cuda._CSRC, "merge_rows.cu")) as fh:
        src = fh.read()
    consts = {m.group(1): m.group(2) for m in
              re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    assert int(consts["kThreads"]) * int(consts["kSteps"]) == compact._MERGE_TILE
    assert consts["kTile"] == "kThreads * kSteps"
    assert int(consts["kFill"]) == compact._MERGE_FILL


def test_merge_wrappers_reject_what_the_kernel_cannot_take():
    keys = torch.full((4, 256), INVALID, dtype=torch.int32)
    with pytest.raises(ValueError, match="R % nb"):
        compact.merge_sorted_rows(keys, nb=3, cap=256)
    with pytest.raises(ValueError, match="R % nb"):
        compact.merge_sorted_rows(keys, nb=0, cap=256)
    with pytest.raises(ValueError, match="chunk"):
        compact.append_rows(keys, cap=256, chunk=100)
    meta = torch.empty((4, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most one payload"):
        compact.merge_sorted_rows(meta, [meta, meta], nb=2, cap=256)
    with pytest.raises(ValueError, match="at most one payload"):
        compact.append_rows(meta, [meta, meta], cap=256, chunk=128)


def test_merge_sorted_rows_empty_row_and_binding_cap_match_jax():
    # 3 groups of 4 rows; row lengths 0 (an empty row) to W (a full row),
    # and a cap that binds in the first two groups
    import jax.numpy as jnp

    from v2ce_toolbox_tpu.ops import compact_pallas as jax_compact

    rng = np.random.RandomState(11)
    r, wd, nb, cap = 12, 256, 4, 640
    lengths = np.array([200, 0, 256, 250, 0, 256, 256, 130, 3, 0, 40, 0])
    keys = np.where(np.arange(wd)[None, :] < lengths[:, None],
                    np.sort(rng.randint(0, 1 << 30, (r, wd)), axis=1),
                    INVALID).astype(np.int32)
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, (r, wd)).astype(np.int32)
    jk, (jp,), jkept, jtot = jax_compact.merge_sorted_rows(
        jnp.asarray(keys), [jnp.asarray(pay)], nb=nb, cap=cap)
    pk, (pp,), pkept, ptot = compact.merge_sorted_rows(
        torch.from_numpy(keys), [torch.from_numpy(pay)], nb=nb, cap=cap)
    for a, b in ((jk, pk), (jp, pp), (jkept, pkept), (jtot, ptot)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert pkept.tolist() == [cap, cap, 43] and ptot.tolist() == [706, 642, 43]
