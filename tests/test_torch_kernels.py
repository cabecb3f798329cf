"""The port's CUDA kernels (K1 gen_compact, K2 compact_rows, K3
merge_sorted_rows) against their plain-torch twins, at the shapes of the
stage-2 main path (24-frame chunks of 260x346 voxels).

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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("density,scale", [(0.05, 1.5), (0.3, 5.0)])
def test_gen_compact_equals_twin_on_card(density, scale):
    dev = _cuda_or_skip()
    rng = np.random.RandomState(4)
    shape = (24, 2, 10, 260, 346)
    v = ((rng.rand(*shape) < density) * rng.rand(*shape) * scale).astype(np.float32)
    v = torch.from_numpy(v).to(dev)
    kw = dict(fps=30, mepv=32, vox_bits=18, cap_bin=1 << 14)
    _assert_equal(gen.gen_compact(v, **kw), gen.gen_compact_torch(v, **kw))


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
