"""The plain twin of the conv GEMM core's live-step pre-pass
(`ops.conv3d.live_steps`, the table the bf16 kernel of
`csrc/conv_igemm.cuh` walks) on the folded weights the core meets: K10's
`fold_decoder_kernel` at decoder_2 and decoder_3 of the full-width model
(and narrow ones), and K11's `fold_s122`. A step is one tap, a BN-wide N
tile and a BK-wide K slice; its multiply-adds count the real (unpadded)
rows and columns it covers. The live steps hold every nonzero weight; at
the fold's own block granularity they hold exactly the nonzeros; with the
tiles the kernel runs, decoder_2 and decoder_3 do 0.630 and 0.905 of the
direct conv's multiply-adds (1.333 and 2.571 for the dense operand), and
the strided conv exactly the direct conv's where BK divides C (4/3 where
a 64-wide slice spans two phases of C = 32)."""

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.ops import conv3d, conv3d_quad, decoder
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _scan(kt, bn, bk):
    """live_steps by a loop over the blocks."""
    p, t, co, c = kt.shape
    out = torch.zeros((p, -(-co // bn), t, -(-c // bk)), dtype=torch.bool)
    for i in range(p):
        for n in range(out.shape[1]):
            for j in range(t):
                for k in range(out.shape[3]):
                    out[i, n, j, k] = bool((kt[i, j, n * bn:(n + 1) * bn,
                                               k * bk:(k + 1) * bk] != 0).any())
    return out


def _live_macs(kt, live, bn, bk):
    """Multiply-adds per output row of the live steps, over real channels."""
    co, c = kt.shape[2:]
    rows = torch.tensor([min(bn, co - n0) for n0 in range(0, co, bn)])
    cols = torch.tensor([min(bk, c - c0) for c0 in range(0, c, bk)])
    return int((live * rows[None, :, None, None] * cols[None, None, None, :]).sum())


def _covers(kt, live, bn, bk):
    """Every nonzero weight lies in a live step."""
    p, t, co, c = kt.shape
    full = live.permute(0, 2, 1, 3).repeat_interleave(bn, 2).repeat_interleave(bk, 3)
    return bool(full[:, :, :co, :c][kt != 0].all())


@pytest.mark.parametrize("bn,bk", [(32, 32), (64, 32), (128, 64)])
def test_live_steps_equals_a_block_scan(bn, bk):
    rng = np.random.RandomState(bn + bk)
    kt = torch.from_numpy(rng.randn(2, 5, 136, 200).astype(np.float32))
    kt[rng.rand(*kt.shape) < 0.3] = 0.0
    kt[0, 1] = 0.0                                  # a whole tap
    kt[1, 2, :64, 32:96] = 0.0                      # whole steps of some tiles
    kt[1, 3, :, :] = -0.0                           # negative zeros are zero
    kt[0, 4] = 0.0
    kt[0, 4, 70, 150] = float("nan")                # a NaN is live
    kt = kt.to(torch.bfloat16)
    got = conv3d.live_steps(kt, bn, bk)
    assert torch.equal(got, _scan(kt, bn, bk))
    assert not got[0, :, 1].any() and not got[1, :, 3].any() and got[0, 70 // bn, 4].any()


@pytest.mark.parametrize("cu,cs,co,proj,ratio", [
    (128, 64, 64, False, 0.630),                    # decoder_2
    (64, 32, 32, True, 0.905),                      # decoder_3, with the projection
    (16, 8, 8, False, None), (32, 16, 8, True, None)])
def test_decoder_fold_live_macs(cu, cs, co, proj, ratio):
    rng = np.random.RandomState(cu + co)
    kern = torch.from_numpy(rng.randn(3, 3, 3, cu + cs, co).astype(np.float32))
    pk = torch.from_numpy(rng.randn(1, 1, 1, cu + cs, co).astype(np.float32)) if proj else None
    kf = decoder.fold_decoder_kernel(kern, cu, pk).to(torch.bfloat16)
    k = cu + 4 * cs
    kt = kf.reshape(2, 18, k, -1).transpose(2, 3)       # (parity, tap, N, K), as the wrapper
    # the direct conv (+ the projection) per coarse position: 4 fine outputs
    direct = 4 * (cu + cs) * co * (27 + proj)
    nnz = int((kt != 0).sum())
    assert nnz <= direct
    # at the fold's own blocks (Co columns, Cs channels) the live steps hold
    # exactly the nonzero weights
    assert _live_macs(kt, conv3d.live_steps(kt, co, cs), co, cs) == nnz
    # the kernel's tiles: every nonzero kept, and the work against the
    # direct conv's and the dense operand's
    bn, bk = decoder.FOLD_TILES
    live = conv3d.live_steps(kt, bn, bk)
    assert _covers(kt, live, bn, bk)
    macs = _live_macs(kt, live, bn, bk)
    assert nnz <= macs <= 36 * k * kt.shape[2]
    if ratio is not None:
        assert round(macs / direct, 3) == ratio and macs < direct
        assert 36 * k * kt.shape[2] / direct > 1.3


@pytest.mark.parametrize("c,co,ratio", [(64, 16, 1.0), (128, 32, 1.0), (32, 64, 4 / 3)])
def test_s122_fold_live_macs(c, co, ratio):
    rng = np.random.RandomState(c)
    k = torch.from_numpy(rng.randn(3, 3, 3, c, co).astype(np.float32)).to(torch.bfloat16)
    _, k4 = conv3d_quad.fold_s122(torch.zeros((1, 1, 2, 2, c), dtype=torch.bfloat16), k)
    kt = k4.permute(0, 1, 2, 4, 3).reshape(1, 12, co, 4 * c)   # (1, tap, Co, 4C), as the wrapper
    bn, bk = conv3d.gemm_tiles(4 * c, co)
    live = conv3d.live_steps(kt, bn, bk)
    assert _covers(kt, live, bn, bk)
    direct = 27 * c * co
    assert int((kt != 0).sum()) == direct        # the fold's nonzeros: the direct conv's
    assert _live_macs(kt, live, bn, bk) == pytest.approx(ratio * direct, rel=1e-12)
    assert 12 * 4 * c * co / direct == pytest.approx(16 / 9)


@pytest.mark.parametrize("planes,taps,c,co,tiles", [
    (1, 27, 96, 32, None), (2, 18, 160, 64, decoder.FOLD_TILES)])
def test_record_live_keeps_the_tables_the_kernel_fills(planes, taps, c, co, tiles):
    # the hook the card checks read the kernel's own table through: one
    # view per bf16 call, shaped as live_steps' table, on the storage the
    # kernel writes; f32 calls and calls outside the block keep nothing
    x = torch.zeros((1, 2, 3, 4, c), dtype=torch.bfloat16)
    with conv3d.record_live() as tables:
        live, nbytes, bn, bk = conv3d.gemm_args(x, planes, taps, c, co, tiles)
        conv3d.gemm_args(x.float(), planes, taps, c, co, tiles)
    conv3d.gemm_args(x, planes, taps, c, co, tiles)
    kt = torch.ones((planes, taps, co, c))
    assert (bn, bk) == (tiles or conv3d.gemm_tiles(c, co))
    assert len(tables) == 1 and tables[0].shape == conv3d.live_steps(kt, bn, bk).shape
    assert tables[0].data_ptr() == live.data_ptr() and tables[0].numel() == nbytes
