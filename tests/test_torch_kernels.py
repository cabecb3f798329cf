"""The port's CUDA kernels (K1 gen_compact, K2 compact_rows, K3
merge_sorted_rows, K4 gen_pack, K5 append_rows) against their plain-torch
twins, at the shapes of the stage-2 paths (24-frame chunks of 260x346
voxels).

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Without a card the kernel tests skip; the dispatch tests run anywhere.
"""

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.ops import compact, gen

INVALID = compact.INVALID


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _rows(seed, r, n, density):
    rng = np.random.RandomState(seed)
    keys = np.where(rng.rand(r, n) < density,
                    rng.randint(0, 1 << 30, (r, n)), INVALID).astype(np.int32)
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, (r, n)).astype(np.int32)
    return keys, pay


def _flat(out):
    res = []
    for o in out:
        res.extend(o if isinstance(o, tuple) else [o])
    return res


def _assert_equal(kernel_out, plain_out):
    a, b = _flat(kernel_out), _flat(plain_out)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:          # kx of the 'none' strategy
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_non_cpu_tensor_never_takes_the_twin():
    vox = torch.empty((1, 2, 10, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gen.gen_compact(vox, fps=30, mepv=32, vox_bits=7, cap_bin=128, chunk=128)
    keys = torch.empty((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        compact.compact_rows(keys, cap=256, chunk=256)
    with pytest.raises(ValueError, match="CUDA"):
        compact.merge_sorted_rows(keys, nb=2, cap=512)
    for strategy in ("slope", "none"):
        with pytest.raises(ValueError, match="CUDA"):
            gen.gen_pack(vox, fps=30, mepv=32, vox_bits=7, strategy=strategy)
    with pytest.raises(ValueError, match="CUDA"):
        gen.gen_compact(vox, fps=30, mepv=32, vox_bits=7, cap_bin=128, chunk=128,
                        strategy="none")
    with pytest.raises(ValueError, match="CUDA"):
        compact.append_rows(keys, [keys], cap=512, chunk=256)


def _voxels(dev, density, scale, shape=(24, 2, 10, 260, 346)):
    rng = np.random.RandomState(4)
    v = ((rng.rand(*shape) < density) * rng.rand(*shape) * scale).astype(np.float32)
    return torch.from_numpy(v).to(dev)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("strategy", ["slope", "none"])
@pytest.mark.parametrize("density,scale", [(0.05, 1.5), (0.3, 5.0)])
def test_gen_compact_equals_twin_on_card(density, scale, strategy):
    v = _voxels(_cuda_or_skip(), density, scale)
    kw = dict(fps=30, mepv=32, vox_bits=18, cap_bin=1 << 14, strategy=strategy)
    _assert_equal(gen.gen_compact(v, **kw), gen.gen_compact_torch(v, **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("strategy", ["slope", "none"])
@pytest.mark.parametrize("density,scale", [(0.05, 1.5), (0.3, 5.0)])
def test_gen_pack_equals_twin_on_card(density, scale, strategy):
    v = _voxels(_cuda_or_skip(), density, scale)
    kw = dict(fps=30, mepv=32, vox_bits=18, strategy=strategy)
    _assert_equal(gen.gen_pack(v, **kw), gen.gen_pack_torch(v, **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_compact_rows_at_grid_width_equals_twin_on_card(density):
    # the grid path's chain compaction: 216 rows of P*H*W = 179,920 keys,
    # not a multiple of 128 nor of the 16384 chunk, with the kx payload
    dev = _cuda_or_skip()
    keys, pay = _rows(6, 216, 2 * 260 * 346, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    _assert_equal(compact.compact_rows(k, [p], cap=16384, chunk=16384),
                  compact.compact_rows_torch(k, [p], cap=16384, chunk=16384))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,cap", [(16384, 4096), (31616, 16384)])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_compact_rows_equals_twin_on_card(n, cap, density):
    dev = _cuda_or_skip()
    keys, pay = _rows(3, 216, n, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=cap),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=cap))
    _assert_equal(compact.compact_rows(k, (), cap=cap, chunk=cap),
                  compact.compact_rows_torch(k, (), cap=cap, chunk=cap))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,n,cap,chunk", [(1, 24 * 147456, 120832, 8192),
                                           (3, 1000, 128, 128), (2, 5000, 1, 2048),
                                           (2, 40000, 12800, 128)])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_compact_rows_few_wide_rows_equal_twin_on_card(r, n, cap, chunk, density):
    # the EventStream route's side list (one row of a chunk's 3,538,944
    # slots), rows shorter than a tile, and caps inside the first tile or a
    # later one
    dev = _cuda_or_skip()
    keys, pay = _rows(7, r, n, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=chunk),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=chunk))
    _assert_equal(compact.compact_rows(k, (), cap=cap, chunk=chunk),
                  compact.compact_rows_torch(k, (), cap=cap, chunk=chunk))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("wd,cap", [(16384, 216 * 16384), (4096, 120832)])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_merge_sorted_rows_equals_twin_on_card(wd, cap, density):
    dev = _cuda_or_skip()
    keys, pay = _rows(5, 216, wd, density)
    k = torch.sort(torch.from_numpy(keys).to(dev), dim=1).values
    p = torch.from_numpy(pay).to(dev)
    _assert_equal(compact.merge_sorted_rows(k, [p], nb=216, cap=cap),
                  compact.merge_sorted_rows_torch(k, [p], nb=216, cap=cap))
    _assert_equal(compact.merge_sorted_rows(k, (), nb=216, cap=cap),
                  compact.merge_sorted_rows_torch(k, (), nb=216, cap=cap))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cap", [24 * 147456, 100000])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_append_rows_equals_twin_on_card(cap, density):
    # the EventStream flatten: 24 per-frame buffers of 147,456 slots, each
    # a valid prefix; the second cap binds (rounded up to the 8192 chunk)
    dev = _cuda_or_skip()
    rng = np.random.RandomState(8)
    r, n = 24, 147456
    lengths = (rng.rand(r) * density * n).astype(np.int64)
    lengths[3] = 0
    keys = np.where(np.arange(n)[None, :] < lengths[:, None],
                    rng.randint(0, 1 << 30, (r, n)), INVALID).astype(np.int32)
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, (r, n)).astype(np.int32)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    _assert_equal(compact.append_rows(k, [p], cap=cap, chunk=8192),
                  compact.append_rows_torch(k, [p], cap=cap, chunk=8192))
    _assert_equal(compact.append_rows(k, (), cap=cap, chunk=8192),
                  compact.append_rows_torch(k, (), cap=cap, chunk=8192))
