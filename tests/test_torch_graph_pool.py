"""The port's graph pooling against the JAX package's on the same inputs:
ids, counts, `perm`, edges and max-pooled features exact (the INT32_MAX
tail of `perm` and INVALID inputs included); the float sums (the `pos`
mean and `edge_attr`) within 1e-6 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from v2ce_toolbox_tpu.models import graph_pool as jgp
from v2ce_toolbox_tpu_torch.models import graph_pool as gp

SUM_RTOL = 1e-6
INVALID = 2**31 - 1


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    """Exact, with the dtype of the JAX output."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _graph(seed, n=300, e=900, graphs=3, d=3, f=5, dead=0.1):
    """Random points (x in [0, 40), y in [0, 30), t in [0, 1)), features,
    batch ids, edges with some endpoints INVALID and validity masks."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 40, n), rng.uniform(0, 30, n), rng.uniform(0, 1, n)],
                   1)[:, :d].astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    batch = np.sort(rng.integers(0, graphs, n)).astype(np.int32)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    ei[:, rng.random(e) < 0.05] = INVALID
    attr = rng.normal(size=(e, 2)).astype(np.float32)
    valid = rng.random(n) > dead
    edge_valid = rng.random(e) > dead
    return pos, x, batch, ei, attr, valid, edge_valid


@pytest.mark.parametrize("kw", [dict(size=2.5), dict(size=[4.0, 3.0], batch=True),
                                dict(size=[5.0, 5.0, 0.5], valid=True),
                                dict(size=3.0, start=[-1.0, 2.0], end=[30.0, 20.0])])
def test_voxel_grid(kw):
    pos, _, batch, _, _, valid, _ = _graph(0)
    d = 3 if isinstance(kw["size"], list) and len(kw["size"]) == 3 else 2
    pos = pos[:, :d]
    args = dict(size=kw["size"], start=kw.get("start"), end=kw.get("end"))
    jb, tb = (_j(batch), _t(batch)) if kw.get("batch") else (None, None)
    jv, tv = (_j(valid), _t(valid)) if kw.get("valid") else (None, None)
    want = jgp.voxel_grid(_j(pos), batch=jb, valid=jv, **args)
    _eq(gp.voxel_grid(_t(pos), batch=tb, valid=tv, **args), want)
    if kw.get("valid"):
        assert (np.asarray(want)[~valid] == INVALID).all()


def test_consecutive_cluster_perm_tail():
    """The documented case, and a random one with INVALID ids: rows K and
    above of perm hold INT32_MAX, as the JAX package's wrap-around gives."""
    ids = np.asarray([5, 3, 5, INVALID, 9, 3], np.int32)
    out, k, perm = gp.consecutive_cluster(_t(ids))
    _eq(perm, np.asarray([1, 0, 4, INVALID, INVALID, INVALID], np.int32))
    for got, want in zip((out, k, perm), jgp.consecutive_cluster(_j(ids))):
        _eq(got, want)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 60, 400).astype(np.int32)
    ids[rng.random(400) < 0.2] = INVALID
    for got, want in zip(gp.consecutive_cluster(_t(ids)), jgp.consecutive_cluster(_j(ids))):
        _eq(got, want)


def test_max_pool_x():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, 300).astype(np.int32)
    ids[::17] = INVALID
    x = rng.normal(size=(300, 5)).astype(np.float32)
    batch = rng.integers(0, 3, 300).astype(np.int32)
    for tb, jb in ((_t(batch), _j(batch)), (None, None)):
        got = gp.max_pool_x(_t(ids), _t(x), tb)
        want = jgp.max_pool_x(_j(ids), _j(x), jb)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                _eq(g, w)
    with pytest.raises(ValueError, match="max_pool_x_sized"):
        gp.max_pool_x(_t(ids), _t(x), None, size=16)


def test_max_pool_x_sized_and_module():
    """Per-graph voxel ids, empty slots and INVALID points; ids past the
    graph count are dropped on both sides; the MaxPoolingX wrapper."""
    pos, x, batch, _, _, valid, _ = _graph(3)
    cluster = np.asarray(jgp.voxel_grid(_j(pos), [10.0, 10.0, 1.0], valid=_j(valid)))
    assert cluster[valid].max() < 12
    for graphs in (3, 2):                  # with 2, graph 2's points fall off the end
        _eq(gp.max_pool_x_sized(_t(cluster), _t(x), _t(batch), graphs, 12),
            jgp.max_pool_x_sized(_j(cluster), _j(x), _j(batch), graphs, 12))
    mod = gp.MaxPoolingX([10.0, 10.0, 1.0], 12)
    ref = jgp.MaxPoolingX([10.0, 10.0, 1.0], 12)
    _eq(mod(_t(x), _t(pos), _t(batch), num_graphs=3, valid=_t(valid)),
        ref(_j(x), _j(pos), _j(batch), num_graphs=3, valid=_j(valid)))
    _eq(mod(_t(x), _t(pos)), ref(_j(x), _j(pos)))
    assert repr(mod) == repr(ref)


def _check_pool_edge(got, want):
    (gi, ga, gn), (wi, wa, wn) = got, want
    _eq(gi, wi)
    _eq(gn, wn)
    if wa is None:
        assert ga is None
    else:
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=SUM_RTOL, atol=0)


def test_pool_edge():
    """The exact case of tests/test_graph_pool.py, then random edges with
    INVALID endpoints, dead edges and negative cluster ids."""
    cl = np.asarray([0, 0, 1, 2], np.int32)
    ei = np.asarray([[0, 1, 0, 2, 3], [2, 2, 1, 3, 2]], np.int32)
    attr = np.arange(5, dtype=np.float32)[:, None] + 1
    _check_pool_edge(gp.pool_edge(_t(cl), _t(ei), _t(attr)),
                     jgp.pool_edge(_j(cl), _j(ei), _j(attr)))
    _, _, _, ei, attr, _, ev = _graph(4)
    rng = np.random.default_rng(5)
    cl = rng.integers(-3, 25, 300).astype(np.int32)
    cl[::13] = INVALID
    _check_pool_edge(gp.pool_edge(_t(cl), _t(ei), _t(attr), _t(ev)),
                     jgp.pool_edge(_j(cl), _j(ei), _j(attr), _j(ev)))
    _check_pool_edge(gp.pool_edge(_t(cl), _t(ei)), jgp.pool_edge(_j(cl), _j(ei)))


@pytest.mark.parametrize("masks", [False, True])
def test_max_pool_and_module(masks):
    pos, x, batch, ei, attr, valid, ev = _graph(6)
    tv, jv = (_t(valid), _j(valid)) if masks else (None, None)
    tev, jev = (_t(ev), _j(ev)) if masks else (None, None)
    mod, ref = gp.MaxPooling([4.0, 3.0]), jgp.MaxPooling([4.0, 3.0])
    got = mod(_t(x), _t(pos), batch=_t(batch), edge_index=_t(ei), valid=tv, edge_valid=tev,
              edge_attr=_t(attr))
    want = ref(_j(x), _j(pos), batch=_j(batch), edge_index=_j(ei), valid=jv, edge_valid=jev,
               edge_attr=_j(attr))
    k, n_e = got[5], got[6]
    for i in (0, 2, 3, 5, 6):
        _eq(got[i], want[i])
    for i in (1, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=SUM_RTOL, atol=0)
    assert 0 < int(k) < len(x) and 0 < int(n_e) < ei.shape[1]
    assert repr(mod) == repr(ref)
    # max_pool itself, without a batch vector
    cl = np.asarray(jgp.voxel_grid(_j(pos[:, :2]), 2.5))
    got = gp.max_pool(_t(cl), _t(x), _t(pos), _t(ei))
    want = jgp.max_pool(_j(cl), _j(x), _j(pos), _j(ei))
    assert got[2] is None and want[2] is None
    for i in (0, 3, 5, 6):
        _eq(got[i], want[i])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=SUM_RTOL, atol=0)


def test_max_pool_is_differentiable():
    """Gradients reach x through the segment max (the JAX ops are
    differentiable in x)."""
    pos, x, _, ei, _, _, _ = _graph(7, n=60, e=120)
    xt = _t(x).requires_grad_(True)
    cl = gp.voxel_grid(_t(pos[:, :2]), 5.0)
    gp.max_pool(cl, xt, _t(pos), _t(ei))[0].sum().backward()
    k = int(gp.consecutive_cluster(cl)[1])
    assert int((xt.grad != 0).sum()) == k * x.shape[1]
