"""The port's CUDA kernels (K1 gen_compact, K2 compact_rows, K3
merge_sorted_rows, K4 gen_pack, K5 append_rows) against their plain-torch
twins, at the shapes of the stage-2 paths (24-frame chunks of 260x346
voxels), the research stage-1 convs (K9 conv3d_3x3x3, K10
fused_up_concat_conv) against theirs: f32 outputs within 1e-5 of the twin
relative to its largest value (sums in another order), bf16 outputs within
8e-3 (one bf16 ulp where an f32 sum straddles a rounding boundary), and
FastFlowNet's cost volume (K8 correlation) at its five pyramid levels
within 1e-5 (the same reason). The probe harness's kernels: K2w (K2's
kernel through its own entry) identical; K11 conv3d_quad within the conv
bounds (its twin sums in f64); K12 conv3d_wino4 within 5e-5 with an f32
output (WINO_TOL) and 8e-3 with a bf16 one, 'nodot' identical; K7 and
K13-K16 identical.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Without a card the kernel tests skip; the dispatch tests run anywhere.
"""

import numpy as np
import pytest
import torch

import os
import re

from v2ce_toolbox_tpu_torch.ops import (_cuda, barrier, compact, conv3d, conv3d_quad,
                                        conv3d_wino4, correlation, decoder, gen, roofline)

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
    _assert_equal(compact.compact_rows(k, [p], cap=16384, chunk=16384, algo="place"),
                  compact.compact_rows_torch(k, [p], cap=16384, chunk=16384))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,cap", [(16384, 4096), (31616, 16384)])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_compact_rows_equals_twin_on_card(n, cap, density):
    dev = _cuda_or_skip()
    keys, pay = _rows(3, 216, n, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=cap, algo="place"),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=cap))
    _assert_equal(compact.compact_rows(k, (), cap=cap, chunk=cap, algo="place"),
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
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=chunk, algo="place"),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=chunk))
    _assert_equal(compact.compact_rows(k, (), cap=cap, chunk=chunk, algo="place"),
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


CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# K12, f32 out: F(4,3)'s collapses lift one ulp of a C-long product, whose
# order differs between kernel and twin, to ~1e-5 of the largest output
WINO_TOL = {torch.float32: 5e-5, torch.bfloat16: 8e-3}
CONV_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]


@pytest.fixture
def no_tf32():
    """The twins' cuDNN f32 convs in full f32 (PyTorch lets cuDNN use TF32
    by default)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def _assert_conv_close(got, want, out_dtype):
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert torch.isfinite(got.float()).all() and err <= CONV_TOL[out_dtype], err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("b,l,h,w,c,co", [
    (1, 4, 6, 16, 16, 16), (2, 3, 5, 13, 24, 40),
    (1, 4, 7, 9, 20, 12),                    # channels padded to the 8-wide vectors
    (1, 16, 17, 22, 512, 512), (1, 16, 33, 44, 768, 256)])
def test_conv3d_equals_twin_on_card(b, l, h, w, c, co, dtype, out_dtype, no_tf32):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c * co)
    x = torch.randn((b, l, h, w, c), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, 3, c, co), generator=g, device=dev) / (27 * c) ** 0.5).to(dtype)
    _assert_conv_close(conv3d.conv3d_3x3x3(x, k, out_dtype),
                       conv3d._conv3d_3x3x3_torch(x, k, out_dtype), out_dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("hc,wc,k,n", [(5, 7, 24, 8), (9, 13, 20, 12),
                                       (65, 87, 384, 128), (130, 173, 192, 128)])
def test_fused_conv_even_equals_twin_on_card(hc, wc, k, n, dtype, out_dtype):
    # the folded input (B, L, hc, wc, Cu + 4 Cs) and weights; the last two
    # are decoder_2 and decoder_3 of the full-width model
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(k * n)
    x = torch.randn((1, 4, hc, wc, k), generator=g, device=dev).to(dtype)
    kf = (torch.randn((2, 3, 2, 3, k, n), generator=g, device=dev) / (18 * k) ** 0.5).to(dtype)
    _assert_conv_close(decoder.fused_conv_even(x, kf, out_dtype),
                       decoder._fused_conv_even_torch(x, kf, out_dtype), out_dtype)


def test_conv_wrappers_never_take_the_twin_off_cpu():
    x = torch.empty((1, 4, 6, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d.conv3d_3x3x3(x, torch.empty((3, 3, 3, 16, 16), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        decoder.fused_conv_even(x, torch.empty((2, 3, 2, 3, 16, 8), device="meta"),
                                torch.float32)


# (C, H, W) of FastFlowNet's five levels for 260x346 frames padded to
# 320x384 (16 pairs a call), and md below 4 on one level
@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,h,w,md", [(32, 80, 96, 4), (64, 40, 48, 4), (64, 20, 24, 4),
                                      (64, 10, 12, 4), (64, 5, 6, 4), (16, 37, 45, 2)])
def test_correlation_equals_twin_on_card(c, h, w, md):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c * h + w)
    f1 = torch.randn((16, c, h, w), generator=g, device=dev)
    f2 = torch.randn((16, c, h, w), generator=g, device=dev)
    got = correlation.correlation(f1, f2, md)
    want = correlation._correlation_torch(f1, f2, md)
    assert got.shape == want.shape == (16, (2 * md + 1) ** 2, h, w)
    err = float((got - want).abs().max() / want.abs().max())
    assert torch.isfinite(got).all() and err <= 1e-5, err


def test_correlation_never_takes_the_twin_off_cpu():
    f = torch.empty((2, 32, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        correlation.correlation(f, f)


# ---------------------------------------------------------------------------
# the probe harness's kernels (tools/perf_probe.py)
# ---------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,n,cap,chunk", [(144, 2048 * 89, 1 << 14, 16384),
                                           (144, 2048 * 89, 1 << 16, 8192),
                                           (3, 1000, 128, 128)])
@pytest.mark.parametrize("density", [0.1, 0.6])
def test_compact_rows_window_equals_twin_on_card(r, n, cap, chunk, density):
    # K2w: the probes' shapes (n padded to the chunk) and a short row
    dev = _cuda_or_skip()
    keys, pay = _rows(8, r, n, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    before = dict(compact.launches)
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=chunk, algo="window"),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=chunk))
    assert compact.launches["compact_rows_window"] == before["compact_rows_window"] + 1
    assert compact.launches["compact_rows"] == before["compact_rows"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("b,l,h,w,c,co,strided", [
    (2, 3, 9, 17, 96, 32, False), (1, 4, 7, 9, 20, 12, False),
    (1, 16, 17, 22, 512, 512, False), (2, 3, 9, 13, 32, 64, True),
    (1, 16, 33, 44, 256, 512, True)])
def test_conv3d_quad_equals_twin_on_card(b, l, h, w, c, co, strided, dtype, out_dtype,
                                         no_tf32):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c * co + strided)
    x = torch.randn((b, l, h, w, c), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, 3, c, co), generator=g, device=dev) / (27 * c) ** 0.5).to(dtype)
    if strided:
        xf, k4 = conv3d_quad.fold_s122(x, k)
        got = conv3d_quad.conv3d_quad_s122(x, k, out_dtype)
        want = conv3d_quad._quad_core_torch(xf, k4, out_dtype)
    else:
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        got = conv3d_quad.conv3d_quad(x, k, out_dtype)
        want = conv3d_quad._quad_core_torch(xp, k, out_dtype)
    _assert_conv_close(got, want, out_dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("shape,co", [((1, 8, 9, 7, 16), 8), ((2, 5, 10, 13, 20), 12),
                                      ((1, 16, 130, 173, 192), 64)])
def test_conv3d_wino4_equals_twin_on_card(shape, co, dtype, out_dtype, no_tf32):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(shape[-1] * co)
    x = (torch.rand(shape, generator=g, device=dev) - 0.5).to(dtype)
    k = (torch.rand((3, 3, 3, shape[-1], co), generator=g, device=dev) * 0.05).to(dtype)
    got = conv3d_wino4.conv3d_wino4(x, k, out_dtype)
    want = conv3d_wino4._conv3d_wino4_torch(x, k, out_dtype)
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert torch.isfinite(got.float()).all() and err <= WINO_TOL[out_dtype], err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,co", [((1, 8, 9, 7, 16), 8), ((1, 5, 10, 13, 8), 8),
                                      ((1, 4, 12, 20, 96), 32)])
def test_conv3d_wino4_nodot_identical_on_card(shape, co, dtype):
    # the transforms and collapses run the twin's ops in its order
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(shape[-1] + co)
    x = (torch.rand(shape, generator=g, device=dev) - 0.5).to(dtype)
    k = (torch.rand((3, 3, 3, shape[-1], co), generator=g, device=dev) * 0.05).to(dtype)
    got = conv3d_wino4.conv3d_wino4(x, k, ablate="nodot")
    assert torch.equal(got, conv3d_wino4._conv3d_wino4_torch(x, k, ablate="nodot"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(144, 11, 128, 128), (2, 3, 8, 128)])
@pytest.mark.parametrize("k", [64, 256, 16])
def test_roofline_probes_equal_twins_on_card(shape, k):
    dev = _cuda_or_skip()
    x = torch.from_numpy(np.random.RandomState(k).randint(0, 1 << 30, shape)
                         .astype(np.int32)).to(dev)
    assert torch.equal(roofline.op_chain(x, k), roofline._op_chain_torch(x, k))
    assert torch.equal(roofline.op_chain_ilp(x, k), roofline._op_chain_ilp_torch(x, k))
    assert torch.equal(roofline.stream_copy(x), x)
    assert torch.equal(roofline.stream_copy_row(x), x)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((1, 16, 260, 346, 20), torch.float32),
                                         ((3, 5, 7), torch.bfloat16), ((1001,), torch.uint8)])
def test_layout_barrier_equals_twin_on_card(shape, dtype):
    dev = _cuda_or_skip()
    x = (torch.rand(shape, device=dev) * 100).to(dtype)
    got = barrier.layout_barrier(x)
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x)


def test_probe_wrappers_never_take_the_twin_off_cpu():
    x = torch.empty((1, 4, 6, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_quad.conv3d_quad(x, torch.empty((3, 3, 3, 16, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_wino4.conv3d_wino4(x, torch.empty((3, 3, 3, 16, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        barrier.layout_barrier(x)
    t = torch.empty((2, 3, 8, 128), dtype=torch.int32, device="meta")
    for fn in (lambda a: roofline.op_chain(a, 8), lambda a: roofline.op_chain_ilp(a, 16),
               roofline.stream_copy, roofline.stream_copy_row,
               lambda a: compact.compact_rows(a[:, 0, 0], cap=128, chunk=128)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t)


def _c_type(decl: str):
    decl = decl.strip()
    if "*" in decl:
        return _cuda._P
    if decl.startswith(("cudaStream_t", "void")):
        return _cuda._P
    if decl.startswith("long long"):
        return _cuda._L
    if decl.startswith("float"):
        return _cuda._F
    if decl.startswith(("int", "uint32_t")):
        return _cuda._I
    raise AssertionError(f"unknown C parameter type: {decl}")


def test_ctypes_signatures_match_the_c_entries():
    # every `extern "C"` entry of csrc/ is bound with its parameters' types,
    # in order: a pointer passed as c_int, or a 64-bit size as c_int, would
    # be cut at the call
    entries = {}
    for name in _cuda._SOURCES:
        with open(os.path.join(_cuda._CSRC, name)) as fh:
            src = fh.read()
        for m in re.finditer(r'extern "C" int (v2ce_\w+)\(([^)]*)\)', src):
            entries[m.group(1)] = [_c_type(p) for p in m.group(2).split(",")]
    assert set(entries) == set(_cuda._SIGNATURES)
    for fn, types in entries.items():
        assert types == _cuda._SIGNATURES[fn], fn
