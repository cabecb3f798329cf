"""The port's CUDA kernels (K1 gen_compact, K2 compact_rows, K3
merge_sorted_rows, K4 gen_pack, K5 append_rows) against their plain-torch
twins, at the shapes of the stage-2 paths (24-frame chunks of 260x346
voxels) and at the edges of the look-back core of K1, K2, K3 and K5
(ragged lengths, views off 16 bytes, long look-backs, caps on tile
boundaries and inside tiles, empty and full rows, replays in a CUDA
graph, 200 rounds of the main-path calls in a child process), the research stage-1 convs (K9 conv3d_3x3x3, K10
fused_up_concat_conv) against theirs: f32 outputs within 1e-5 of the twin
relative to its largest value (sums in another order), bf16 outputs within
8e-3 (one bf16 ulp where an f32 sum straddles a rounding boundary), and
FastFlowNet's cost volume (K8 correlation) at its five pyramid levels
within 1e-5 (the same reason), its tap subset identical to the full
volume's planes and written into a wider buffer without touching the
channels around it. The probe harness's kernels: K2w (K2's kernel with
8,192-key tiles) identical, on unpadded rows of any length and alignment;
K11 conv3d_quad within the conv bounds (its twin sums in f64); K12
conv3d_wino4 within 5e-5 with an f32
output (WINO_TOL) and 8e-3 with a bf16 one, 'nodot' identical, and its
fused bf16 route's scratch without Z; K7 and K13-K16 identical (K16 also
at ragged row counts, lengths and alignments).

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Without a card the kernel tests skip; the dispatch tests run anywhere.
"""

import numpy as np
import pytest
import torch

import os
import re
import subprocess
import sys

from v2ce_toolbox_tpu_torch.models.fastflownet import CORR_INDEX
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


def _on_card(a, dev, view=False):
    """a on the card; with view, as a contiguous view that starts one
    element past a 16-byte boundary (as `side_in[None]`-style views can)."""
    t = torch.from_numpy(a).to(dev)
    if not view:
        return t
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1)
    v = flat[1:].view(t.shape)
    assert v.data_ptr() % 16 != 0
    return v


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,n,cap,chunk,density,view", [
    (3, 16387, 8192, 8192, 0.5, False),              # n % 4 != 0: key-by-key loads
    (2, 16384, 4096, 4096, 0.5, True),               # keys off 16 bytes
    (1, 8192 * 300 + 8, 1 << 20, 8192, 0.3, False),  # 601 tiles: a long look-back
    (4, 32768, 8192, 8192, 1.0, False),              # all valid, cap on a tile boundary
    (3, 20000, 4096, 4096, 0.0, False),              # all INVALID
    (2, 24576, 30000, 128, 1.0, False),              # all valid, the tail past n
])
def test_compact_rows_core_paths_equal_twin_on_card(r, n, cap, chunk, density, view):
    # the look-back core's paths (4,096-key tiles, 16-byte loads where n % 4
    # == 0 and the keys start on 16 bytes, fill tiles for the tail)
    dev = _cuda_or_skip()
    keys, pay = _rows(9, r, n, density)
    k, p = _on_card(keys, dev, view), _on_card(pay, dev, view)
    for pays in ([p], ()):
        _assert_equal(compact.compact_rows(k, pays, cap=cap, chunk=chunk, algo="place"),
                      compact.compact_rows_torch(k, pays, cap=cap, chunk=chunk))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("strategy", ["slope", "none"])
@pytest.mark.parametrize("shape,cap_bin,chunk,view", [
    ((2, 2, 10, 23, 47), 512, 128, False),     # H*W % 4 != 0, the last tile partial
    ((3, 2, 10, 32, 48), 1024, 128, False),    # 3 whole tiles a frame
    ((2, 2, 10, 20, 30), 128, 128, True),      # voxels off 16 bytes, caps bind
    ((24, 2, 10, 260, 346), 4096, 4096, False),  # the main-path grid, cap = a fill chunk
])
def test_gen_compact_core_paths_equal_twin_on_card(shape, cap_bin, chunk, view, strategy):
    dev = _cuda_or_skip()
    rng = np.random.RandomState(5)
    v = ((rng.rand(*shape) < 0.3) * rng.rand(*shape) * 5.0).astype(np.float32)
    v = _on_card(v, dev, view)
    kw = dict(fps=30, mepv=32, vox_bits=int(np.ceil(np.log2(2 * shape[3] * shape[4]))),
              cap_bin=cap_bin, chunk=chunk, strategy=strategy)
    _assert_equal(gen.gen_compact(v, **kw), gen.gen_compact_torch(v, **kw))


STRESS_ITERS = 200        # rounds of stress_lookback's or stress_merge's calls
STRESS_TIMEOUT_S = 300    # the child's start, its inputs and twins, and the calls


def stress_lookback(iters):
    """Back-to-back K1, K2 and K2w calls with no host sync between them:
    K1 'slope' over (24, 2, 10, 260, 346) voxels at the default sampler's
    cap, then K2 at the main-path shapes of a 24-frame chunk, (216, 16384)
    -> 4096 with a payload, (216, 31616) -> 16384 and (216, 16384) -> 4096,
    then K2w at the probe shape (144, 182272) -> 16384 with a payload and
    at (216, 31615) -> 4096. Every output of every call is held against
    its twin's on the card; returns the number of outputs that differ
    (synced once, at the end)."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import ldati

    dev = _cuda_or_skip()
    _cuda.lib()
    scfg = SamplerConfig()
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (24, 2, 10, 260, 346)
    v = ((torch.rand(shape, generator=g, device=dev) < 0.3)
         * torch.rand(shape, generator=g, device=dev) * 5.0).contiguous()
    kw = dict(fps=30, mepv=scfg.max_events_per_voxel, vox_bits=ldati.vox_bits_of(2, 260, 346),
              cap_bin=scfg.cap_bin)
    calls = [(lambda: gen.gen_compact(v, **kw), gen.gen_compact_torch(v, **kw))]
    for seed, (n, cap, density, with_pay) in enumerate(
            [(16384, 4096, 0.3, True), (31616, 16384, 0.3, False), (16384, 4096, 0.05, False)]):
        keys, pay = _rows(30 + seed, 216, n, density)
        k = torch.from_numpy(keys).to(dev)
        pays = [torch.from_numpy(pay).to(dev)] if with_pay else []
        calls.append((lambda k=k, pays=pays, cap=cap: compact.compact_rows(
            k, pays, cap=cap, chunk=4096, algo="place"),
            compact.compact_rows_torch(k, pays, cap=cap, chunk=4096)))
    # K2w: the probe rows with the payload (16-byte loads), and ragged rows
    # without (key by key)
    for seed, (r, n, cap, chunk, with_pay) in enumerate(
            [(144, 2048 * 89, 16384, 16384, True), (216, 31615, 4096, 4096, False)]):
        keys, pay = _rows(40 + seed, r, n, 0.1)
        k = torch.from_numpy(keys).to(dev)
        pays = [torch.from_numpy(pay).to(dev)] if with_pay else []
        calls.append((lambda k=k, pays=pays, cap=cap, chunk=chunk: compact.compact_rows(
            k, pays, cap=cap, chunk=chunk, algo="window"),
            compact.compact_rows_torch(k, pays, cap=cap, chunk=chunk)))
    for run, ref in calls:                        # shapes and dtypes, once
        _assert_equal(run(), ref)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(iters):
        for run, ref in calls:
            for x, y in zip(_flat(run()), _flat(ref)):
                if x is not None:
                    bad += (x != y).any()
    return int(bad)


def _stress_in_child(fn, what):
    """Runs tests.test_torch_kernels.<fn>(STRESS_ITERS) in a child process,
    so a hang ends at the timeout as a failure here."""
    _cuda_or_skip()
    _cuda.lib()                                   # build before the child starts
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"from tests.test_torch_kernels import {fn}; "
            f"print('differing outputs', {fn}({STRESS_ITERS}))")
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=STRESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{STRESS_ITERS} rounds of {what} calls did not end within "
                    f"{STRESS_TIMEOUT_S} s: a look-back wait never ended")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "differing outputs 0", proc.stdout


@pytest.mark.requires_cuda
def test_compaction_back_to_back_calls_never_hang_on_card():
    # an ordering fault of the look-back (a tile that waits for a flag no
    # store ever leaves) hangs the card only now and then
    _stress_in_child("stress_lookback", "K1, K2 and K2w")


def _prefix_rows(seed, lengths, w):
    """Rows of width w whose first lengths[i] keys are valid (sorted) and
    the rest INVALID, the precondition of K3 and K5, and a payload."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths)
    keys = np.where(np.arange(w)[None, :] < lengths[:, None],
                    np.sort(rng.randint(0, 1 << 30, (len(lengths), w)), axis=1),
                    INVALID).astype(np.int32)
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, keys.shape).astype(np.int32)
    return keys, pay


def _merge_calls(dev, seed):
    """K3's two main-path calls of the center CLI ((216, 16384) -> one
    3,538,944-slot row, the (216, 4096) side list -> 120,832 slots), K3's
    per-frame merge of the EventStream route ((216, 16384) in 24 groups of
    9 -> 147,456 with a payload) and K5's flatten ((24, 147456) -> one row
    with a payload), on prefix rows of random lengths (some empty, some
    full): [(run, twin's output)]."""
    rng = np.random.RandomState(seed)
    calls = []
    for w, nb, cap, with_pay in [(16384, 216, 216 * 16384, False), (4096, 216, 120832, False),
                                 (16384, 9, 147456, True)]:
        lengths = rng.randint(0, w + 1, 216)
        lengths[::17], lengths[5::23] = 0, w
        keys, pay = _prefix_rows(seed + w, lengths, w)
        k = torch.from_numpy(keys).to(dev)
        pays = [torch.from_numpy(pay).to(dev)] if with_pay else []
        calls.append((lambda k=k, pays=pays, nb=nb, cap=cap: compact.merge_sorted_rows(
            k, pays, nb=nb, cap=cap), compact.merge_sorted_rows_torch(k, pays, nb=nb, cap=cap)))
    lengths = rng.randint(0, 147457, 24)
    lengths[3], lengths[7] = 0, 147456
    keys, pay = _prefix_rows(seed + 1, lengths, 147456)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    calls.append((lambda: compact.append_rows(k, [p], cap=24 * 147456, chunk=8192),
                  compact.append_rows_torch(k, [p], cap=24 * 147456, chunk=8192)))
    return calls


def stress_merge(iters):
    """Back-to-back K3 and K5 calls at the main-path shapes (_merge_calls),
    with no host sync between them; every output of every call is held
    against its twin's on the card. Returns the number of outputs that
    differ (synced once, at the end)."""
    dev = _cuda_or_skip()
    _cuda.lib()
    calls = _merge_calls(dev, 40)
    for run, ref in calls:                        # shapes and dtypes, once
        _assert_equal(run(), ref)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(iters):
        for run, ref in calls:
            for x, y in zip(_flat(run()), _flat(ref)):
                bad += (x != y).any()
    return int(bad)


@pytest.mark.requires_cuda
def test_merge_back_to_back_calls_never_hang_on_card():
    _stress_in_child("stress_merge", "K3 and K5")


@pytest.mark.requires_cuda
def test_compaction_graph_replays_reset_the_lookback_on_card():
    # one K2, one K1 and one K2w call captured in a CUDA graph, replayed
    # over new inputs: each replay's memset must clear the previous one's
    # ticket and status words, or the offsets (and the tickets) would be
    # stale
    dev = _cuda_or_skip()
    r, n = 4, 8192 * 5 + 100
    k = torch.empty((r, n), dtype=torch.int32, device=dev)
    p = torch.empty_like(k)
    v = torch.empty((2, 2, 10, 64, 96), device=dev)
    kw = dict(fps=30, mepv=32, vox_bits=14, cap_bin=2048, chunk=128)

    def load(seed):
        keys, pay = _rows(seed, r, n, 0.2 + 0.2 * (seed % 3))
        k.copy_(torch.from_numpy(keys))
        p.copy_(torch.from_numpy(pay))
        rng = np.random.RandomState(seed)
        v.copy_(torch.from_numpy(((rng.rand(*v.shape) < 0.3) * rng.rand(*v.shape)
                                  * (2.0 + seed % 4)).astype(np.float32)))

    def run():
        return (compact.compact_rows(k, [p], cap=8192, chunk=8192, algo="place"),
                gen.gen_compact(v, **kw),
                compact.compact_rows(k, [p], cap=8192, chunk=8192, algo="window"))

    load(20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    for seed in (21, 22, 23):
        load(seed)
        g.replay()
        torch.cuda.synchronize()
        _assert_equal(out[0], compact.compact_rows_torch(k, [p], cap=8192, chunk=8192))
        _assert_equal(out[1], gen.gen_compact_torch(v, **kw))
        _assert_equal(out[2], out[0])


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


@pytest.mark.requires_cuda
def test_merge_sorted_rows_groups_equal_twin_on_card():
    # the per-frame merge of the EventStream route (ldati.py:546): 24 groups
    # of 9 rows of 16,384 -> 147,456 slots each, with a payload
    dev = _cuda_or_skip()
    lengths = np.random.RandomState(12).randint(0, 16385, 216)
    lengths[::10], lengths[4::13] = 0, 16384
    keys, pay = _prefix_rows(12, lengths, 16384)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    for pays in ([p], ()):
        _assert_equal(compact.merge_sorted_rows(k, pays, nb=9, cap=147456),
                      compact.merge_sorted_rows_torch(k, pays, nb=9, cap=147456))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lengths,w,nb,cap", [
    # empty and full rows: a full row's next tile is the next row's first,
    # a row of exactly one tile leaves its second tile's probe on INVALID
    ([0, 8192, 8192, 1, 8191, 0, 4096, 4097, 0, 0, 0, 8192], 8192, 3, 3 * 8192),
    # the cap binds mid-row on a tile boundary (9984 + 8192), and mid-tile
    ([9984, 16384, 0, 300, 16384, 16384], 16384, 3, 18176),
    ([9984, 16384, 0, 300, 16384, 16384], 16384, 3, 14976),
    # W not a multiple of the tile, caps below one fill chunk
    ([4224, 0, 4100, 17, 4224, 4223], 4224, 2, 4352),
    ([4224, 4224, 4224, 4224], 4224, 4, 128),
])
def test_merge_sorted_rows_edges_equal_twin_on_card(lengths, w, nb, cap):
    dev = _cuda_or_skip()
    keys, pay = _prefix_rows(13, lengths, w)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    for pays in ([p], ()):
        _assert_equal(compact.merge_sorted_rows(k, pays, nb=nb, cap=cap),
                      compact.merge_sorted_rows_torch(k, pays, nb=nb, cap=cap))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("w,cap,chunk,view", [
    (5001, 16384, 8192, False),    # W % 4 != 0: key-by-key staging
    (8192, 11000, 128, True),      # keys off 16 bytes, the cap binds mid-tile
    (4096, 8192, 8192, False),     # the cap binds on a tile boundary
    (12288, 64, 128, False),       # a cap below one fill chunk
])
def test_append_rows_edges_equal_twin_on_card(w, cap, chunk, view):
    dev = _cuda_or_skip()
    lengths = np.random.RandomState(w).randint(0, w + 1, 6)
    lengths[1], lengths[4] = 0, w
    if w == 4096:
        lengths[:] = [w, w, 0, w, w, 5]
    keys, pay = _prefix_rows(14, lengths, w)
    k, p = _on_card(keys, dev, view), _on_card(pay, dev, view)
    for pays in ([p], ()):
        _assert_equal(compact.append_rows(k, pays, cap=cap, chunk=chunk),
                      compact.append_rows_torch(k, pays, cap=cap, chunk=chunk))


@pytest.mark.requires_cuda
def test_merge_graph_replays_reset_the_lookback_on_card():
    # a K3 call (3 groups, with a payload) and a K5 call captured in a CUDA
    # graph, replayed over new row lengths: the memset of each call's
    # scratch replays with it
    dev = _cuda_or_skip()
    k3 = torch.empty((12, 8192), dtype=torch.int32, device=dev)
    p3 = torch.empty_like(k3)
    k5 = torch.empty((6, 5001), dtype=torch.int32, device=dev)
    p5 = torch.empty_like(k5)

    def load(seed):
        rng = np.random.RandomState(seed)
        for k, p in ((k3, p3), (k5, p5)):
            keys, pay = _prefix_rows(seed, rng.randint(0, k.shape[1] + 1, k.shape[0]),
                                     k.shape[1])
            k.copy_(torch.from_numpy(keys))
            p.copy_(torch.from_numpy(pay))

    def run():
        return (compact.merge_sorted_rows(k3, [p3], nb=4, cap=20480),
                compact.append_rows(k5, [p5], cap=20000, chunk=128))

    load(30)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    for seed in (31, 32, 33):
        load(seed)
        g.replay()
        torch.cuda.synchronize()
        _assert_equal(out[0], compact.merge_sorted_rows_torch(k3, [p3], nb=4, cap=20480))
        _assert_equal(out[1], compact.append_rows_torch(k5, [p5], cap=20000, chunk=128))


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


def _kernel_live_table(run, kt, tiles=None):
    """Runs `run`, which makes one bf16 conv call, and asserts that the
    live-step table the kernel's pre-pass filled equals the plain twin's
    on the weights kt (planes, taps, Co, C), padded as the wrappers pad
    them, with `tiles` (default `conv3d.gemm_tiles`). Returns run()'s
    output."""
    kt = conv3d.kernel_operand(kt, 2, 3)
    tiles = tiles or conv3d.gemm_tiles(kt.shape[3], kt.shape[2])
    with conv3d.record_live() as tables:
        out = run()
    assert len(tables) == 1
    got, want = tables[0].cpu(), conv3d.live_steps(kt, *tiles).cpu()
    assert got.shape == want.shape and int(got.max()) <= 1
    assert torch.equal(got.bool(), want), (int(got.sum()), int(want.sum()))
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("b,l,h,w,c,co", [
    (1, 4, 6, 16, 16, 16), (2, 3, 5, 13, 24, 40),
    (1, 4, 7, 9, 20, 12),                    # channels padded to the 8-wide vectors
    (1, 16, 17, 22, 512, 512), (1, 16, 33, 44, 768, 256),
    (1, 4, 260, 346, 32, 32),                # Co = 32: the 32-wide N tile
    (1, 3, 20, 30, 2, 32),                   # C = 8 after padding: the first layer
    (2, 3, 9, 37, 64, 64)])                  # a ragged W edge past every box width
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES[1:])
@pytest.mark.parametrize("hc,wc,cu,cs,co,proj", [
    (65, 87, 128, 64, 64, False),            # decoder_2 of the full-width model
    (130, 173, 64, 32, 32, True),            # decoder_3, with the projection
    (9, 13, 16, 8, 8, True), (5, 7, 24, 16, 16, False)])
def test_fused_conv_even_on_folded_weights_on_card(hc, wc, cu, cs, co, proj, dtype, out_dtype):
    # the weights really come from the fold, so the kernel's live-step
    # pre-pass finds its zero blocks and skips them
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(cu * co + proj)
    x = torch.randn((1, 4, hc, wc, cu + 4 * cs), generator=g, device=dev).to(dtype)
    kern = torch.randn((3, 3, 3, cu + cs, co), generator=g, device=dev) / (27 * (cu + cs)) ** 0.5
    pk = torch.randn((1, 1, 1, cu + cs, co), generator=g, device=dev) if proj else None
    kf = decoder.fold_decoder_kernel(kern, cu, pk).to(dtype)
    kt = kf.reshape(2, 18, cu + 4 * cs, -1).transpose(2, 3)
    assert not bool(conv3d.live_steps(kt, *decoder.FOLD_TILES).all())
    got = _kernel_live_table(lambda: decoder.fused_conv_even(x, kf, out_dtype), kt,
                             decoder.FOLD_TILES)
    _assert_conv_close(got, decoder._fused_conv_even_torch(x, kf, out_dtype), out_dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,entry", [(128, 128, "conv3d"), (96, 32, "conv3d"),
                                        (192, 128, "decoder"), (256, 64, "quad")])
def test_conv_core_skips_planted_zero_blocks_on_card(c, co, entry, out_dtype, no_tf32):
    # random bf16 weights with zero blocks planted at the core's step
    # granularity (whole taps, K slices and N tiles, and a block inside
    # one step): the kernel, which skips the dead steps, equals the twin
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c + co)
    x = torch.randn((1, 4, 13, 21, c), generator=g, device=dev).to(torch.bfloat16)
    if entry == "decoder":
        k = torch.randn((2, 3, 2, 3, c, co), generator=g, device=dev) / (18 * c) ** 0.5
        k[0, 1] = 0                                   # three taps of parity 0
        k[1, :, :, :, 32:96, :64] = 0                 # K slices of one N tile
        k[:, 2, 1, 2] = 0                             # one tap in both parities
        k = k.to(torch.bfloat16)
        got = _kernel_live_table(lambda: decoder.fused_conv_even(x, k, out_dtype),
                                 k.reshape(2, 18, c, co).transpose(2, 3), decoder.FOLD_TILES)
        want = decoder._fused_conv_even_torch(x, k, out_dtype)
    else:
        k = torch.randn((3, 3, 3, c, co), generator=g, device=dev) / (27 * c) ** 0.5
        k[0, :, 1] = 0                                # three taps
        k[2, 2, :, : c // 2] = 0                      # the first K slices of three taps
        k[1, 1, 1, :, : co // 2] = 0                  # half of N at the centre tap
        k[:, :, :, 8:16] = 0                          # a block inside every step
        k = k.to(torch.bfloat16)
        fn = conv3d.conv3d_3x3x3 if entry == "conv3d" else conv3d_quad.conv3d_quad
        got = _kernel_live_table(lambda: fn(x, k, out_dtype),
                                 k.permute(0, 1, 2, 4, 3).reshape(1, 27, co, c))
        if entry == "conv3d":
            want = conv3d._conv3d_3x3x3_torch(x, k, out_dtype)
        else:
            want = conv3d_quad._quad_core_torch(
                torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), k, out_dtype)
    _assert_conv_close(got, want, out_dtype)


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


# K8's tap subset: FastFlowNet's 53 taps at its five levels, and a subset
# out of order at W = 6 (no TMA: its rows are not 16-byte strided) and on a
# ragged 37x45 map at md 2
@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,h,w,md", [(32, 80, 96, 4), (64, 40, 48, 4), (64, 20, 24, 4),
                                      (64, 10, 12, 4), (64, 5, 6, 4), (16, 37, 45, 2)])
def test_correlation_taps_equal_full_planes_on_card(c, h, w, md):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c * h + w + 1)
    f1 = torch.randn((16, c, h, w), generator=g, device=dev)
    f2 = torch.randn((16, c, h, w), generator=g, device=dev)
    d2 = (2 * md + 1) ** 2
    taps = CORR_INDEX.tolist() if md == 4 else [d2 - 1, 0, d2 // 2, 3, 7, 11]
    full = correlation.correlation(f1, f2, md)
    got = correlation.correlation(f1, f2, md, taps=taps)
    assert got.shape == (16, len(taps), h, w)
    assert torch.equal(got, full[:, taps])
    want = correlation._correlation_torch(f1, f2, md)[:, taps]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,w", [(40, 48), (5, 6), (37, 45)])
def test_correlation_out_view_leaves_neighbours_on_card(h, w):
    """Taps written into channels 3.. of a wider buffer (batch stride
    larger than T*H*W) leave the channels around them as they were."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(h * w)
    f1 = torch.randn((4, 32, h, w), generator=g, device=dev)
    f2 = torch.randn((4, 32, h, w), generator=g, device=dev)
    t = len(CORR_INDEX)
    buf = torch.full((4, t + 8, h, w), -7.0, device=dev)
    got = correlation.correlation(f1, f2, 4, taps=CORR_INDEX, out=buf[:, 3:3 + t])
    assert got.data_ptr() == buf[:, 3].data_ptr()
    assert torch.equal(buf[:, 3:3 + t], correlation.correlation(f1, f2, 4)[:, CORR_INDEX])
    assert bool((buf[:, :3] == -7).all()) and bool((buf[:, 3 + t:] == -7).all())


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
    # K2w: the probes' shapes (182,272 keys a row, not a multiple of either
    # chunk, which the kernel takes unpadded) and a short row
    dev = _cuda_or_skip()
    keys, pay = _rows(8, r, n, density)
    k, p = torch.from_numpy(keys).to(dev), torch.from_numpy(pay).to(dev)
    before = dict(compact.launches)
    _assert_equal(compact.compact_rows(k, [p], cap=cap, chunk=chunk, algo="window"),
                  compact.compact_rows_torch(k, [p], cap=cap, chunk=chunk))
    assert compact.launches["compact_rows_window"] == before["compact_rows_window"] + 1
    assert compact.launches["compact_rows"] == before["compact_rows"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,n,cap,chunk,density,view", [
    (3, 16387, 8192, 8192, 0.5, False),      # n % chunk != 0 and n % 4 != 0: key by key
    (2, 16384, 4096, 4096, 0.5, True),       # keys off 16 bytes: key by key
    (5, 1000, 256, 128, 0.6, False),         # n smaller than one tile, the cap binds
    (4, 0, 256, 256, 0.5, False),            # no keys: fill tiles only
    (4, 32768, 8192, 8192, 1.0, False),      # all valid, cap on a tile boundary
    (3, 40000, 5000, 128, 1.0, False),       # all valid, cap inside a tile (5,120)
    (3, 20000, 4096, 4096, 0.0, False),      # all INVALID
    (1, 4096 * 600 + 12, 1 << 20, 8192, 0.3, False),   # 301 tiles: a long look-back
    (144, 2048 * 89, 1 << 14, 16384, 0.3, False),      # the probe rows, the cap binds early
])
def test_compact_rows_window_core_paths_equal_twin_on_card(r, n, cap, chunk, density, view):
    # K2w's tiles of 8,192 keys, unpadded rows: 16-byte loads where n % 4
    # == 0 and the keys start on 16 bytes, key by key otherwise; fill tiles
    # for the tail
    dev = _cuda_or_skip()
    keys, pay = _rows(10, r, n, density)
    k, p = _on_card(keys, dev, view), _on_card(pay, dev, view)
    for pays in ([p], ()):
        _assert_equal(compact.compact_rows(k, pays, cap=cap, chunk=chunk, algo="window"),
                      compact.compact_rows_torch(k, pays, cap=cap, chunk=chunk))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("b,l,h,w,c,co,strided", [
    (2, 3, 9, 17, 96, 32, False), (1, 4, 7, 9, 20, 12, False),
    (1, 16, 17, 22, 512, 512, False), (2, 3, 9, 13, 32, 64, True),
    (1, 16, 33, 44, 256, 512, True),
    (1, 4, 260, 346, 96, 32, False),         # dec3_c1's Co = 32 at full width
    (1, 4, 260, 346, 32, 64, True),          # enc1_c1s2: 4C = 128 through fold_s122
    (1, 5, 65, 87, 128, 256, True)])
def test_conv3d_quad_equals_twin_on_card(b, l, h, w, c, co, strided, dtype, out_dtype,
                                         no_tf32):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(c * co + strided)
    x = torch.randn((b, l, h, w, c), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, 3, c, co), generator=g, device=dev) / (27 * c) ** 0.5).to(dtype)
    if strided:
        xf, k4 = conv3d_quad.fold_s122(x, k)
        run = lambda: conv3d_quad.conv3d_quad_s122(x, k, out_dtype)  # noqa: E731
        got = (_kernel_live_table(run, k4.permute(0, 1, 2, 4, 3).reshape(1, 12, co, 4 * c))
               if dtype == torch.bfloat16 else run())
        want = conv3d_quad._quad_core_torch(xf, k4, out_dtype)
    else:
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        got = conv3d_quad.conv3d_quad(x, k, out_dtype)
        want = conv3d_quad._quad_core_torch(xp, k, out_dtype)
    _assert_conv_close(got, want, out_dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,out_dtype", CONV_DTYPES)
@pytest.mark.parametrize("shape,co", [
    ((1, 8, 9, 7, 16), 8), ((2, 5, 10, 13, 20), 12), ((1, 16, 130, 173, 192), 64),
    # the fused bf16 kernel's edges: W past one and two 64-row runs, L and
    # H not multiples of 4, C not a multiple of BK (two K steps, the last
    # ragged), Co of one partial, one full and more than two 32-wide N tiles
    ((1, 6, 7, 70, 40), 24), ((2, 5, 10, 130, 20), 72), ((1, 8, 9, 65, 96), 64),
    ((1, 4, 5, 64, 8), 8), ((1, 3, 6, 129, 64), 32)])
def test_conv3d_wino4_equals_twin_on_card(shape, co, dtype, out_dtype, no_tf32):
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(shape[-1] * co)
    x = (torch.rand(shape, generator=g, device=dev) - 0.5).to(dtype)
    k = (torch.rand((3, 3, 3, shape[-1], co), generator=g, device=dev) * 0.05).to(dtype)
    if dtype == torch.bfloat16:
        # the fused kernel's live-step table: the twin's on U (36, 3, Co, C)
        plan = conv3d_wino4.fused_plan(shape[-1], co)
        got = _kernel_live_table(lambda: conv3d_wino4.conv3d_wino4(x, k, out_dtype),
                                 conv3d_wino4.gemm_weights(k, dtype), (plan["bn"], plan["bk"]))
    else:
        got = conv3d_wino4.conv3d_wino4(x, k, out_dtype)
    want = conv3d_wino4._conv3d_wino4_torch(x, k, out_dtype)
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert torch.isfinite(got.float()).all() and err <= WINO_TOL[out_dtype], err


@pytest.mark.requires_cuda
def test_conv3d_wino4_bf16_allocates_no_z_on_card():
    # at the probe's dec3_conv1 shape, bf16 'full' allocates its output, U,
    # the live table and V (36, M, Cv) bf16, with 64 MB to spare: the
    # three-launch route's Z (36, M, 3 Co) f32, 1.25 GB here, does not fit
    dev = _cuda_or_skip()
    (b, l, h, w, c), co = (1, 16, 260, 346, 96), 32
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((b, l, h, w, c), generator=g, device=dev) - 0.5).bfloat16()
    k = (torch.rand((3, 3, 3, c, co), generator=g, device=dev) * 0.05).bfloat16()
    plan = conv3d_wino4.fused_plan(c, co)
    m = b * -(-l // 4) * -(-h // 4) * (w + 2)
    allowed = (b * l * h * w * co * 4 + 36 * 3 * co * c * 2
               + 36 * plan["n_tiles"] * 3 * plan["nk"] + 36 * m * c * 2 + (64 << 20))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = conv3d_wino4.conv3d_wino4(x, k)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert out.shape == (b, l, h, w, co) and torch.isfinite(out).all()
    assert rise <= allowed, (rise, allowed)


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


# a K13 thread carries 32 (chunk, sublane) positions, a K14 thread 16 (x 4
# chains): shapes whose position count neither divides, one chunk, one
# sublane; k = 0 (no round), 4 (one K13 round, none of K14's) and 18
@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(144, 11, 128, 128), (2, 3, 8, 128), (3, 5, 8, 128),
                                   (1, 1, 1, 128), (2, 1, 8, 128), (5, 7, 3, 128)])
@pytest.mark.parametrize("k", [64, 256, 16, 0, 4, 18])
def test_roofline_probes_equal_twins_on_card(shape, k):
    dev = _cuda_or_skip()
    x = torch.from_numpy(np.random.RandomState(k).randint(0, 1 << 30, shape)
                         .astype(np.int32)).to(dev)
    assert torch.equal(roofline.op_chain(x, k), roofline._op_chain_torch(x, k))
    assert torch.equal(roofline.op_chain_ilp(x, k), roofline._op_chain_ilp_torch(x, k))
    assert torch.equal(roofline.stream_copy(x), x)
    assert torch.equal(roofline.stream_copy_row(x), x)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,offset", [((145, 11, 128, 128), 0), ((133, 3, 5, 128), 0),
                                          ((7, 11, 40, 128), 1), ((3, 1, 1, 128), 3)])
def test_stream_copy_row_equals_clone_on_card(shape, offset):
    """K16 at row counts that are not a multiple of the card's 132 SMs, rows
    that are not a multiple of the ring's 16 KB stage, and sources 4 or 12
    bytes past a 16-byte boundary (a contiguous view into a larger
    buffer)."""
    dev = _cuda_or_skip()
    n = int(np.prod(shape))
    base = torch.from_numpy(np.random.RandomState(n).randint(0, 1 << 30, n + 4)
                            .astype(np.int32)).to(dev)
    x = base[offset:offset + n].view(shape)
    assert (x.data_ptr() % 16 == 4 * offset)
    got = roofline.stream_copy_row(x)
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, x.clone())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,row_bytes,src_off,dst_off", [
    (133, 16384 * 3 + 1000, 0, 0), (5, 1001, 3, 3), (4, 40000 + 13, 7, 7), (3, 5000, 1, 2),
    (2, 9, 5, 5)])
def test_stream_copy_row_entry_any_length_on_card(rows, row_bytes, src_off, dst_off):
    """The C entry of K16 on byte rows whose length is not a multiple of 16
    and whose starts are not 16-byte aligned: the head and tail bytes by
    the warp, the rest by the bulk copies (all by the warp where the two
    pointers differ in their 16-byte phase)."""
    dev = _cuda_or_skip()
    n = rows * row_bytes
    src = torch.from_numpy(np.random.RandomState(row_bytes).randint(0, 256, n + 16)
                           .astype(np.uint8)).to(dev)
    dst = torch.zeros(n + 16, dtype=torch.uint8, device=dev)
    err = _cuda.lib().v2ce_stream_copy_row(src.data_ptr() + src_off, dst.data_ptr() + dst_off,
                                           rows, row_bytes, _cuda.stream_of(src))
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(dst[dst_off:dst_off + n], src[src_off:src_off + n])
    assert int(dst[:dst_off].count_nonzero()) == 0
    assert int(dst[dst_off + n:].count_nonzero()) == 0


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
