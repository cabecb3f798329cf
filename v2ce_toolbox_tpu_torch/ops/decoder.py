"""K10: the decoder block's nearest-up2 + concat + 3x3x3 conv (+ the 1x1x1
residual projection) on the coarse grid, for the research configuration
(subpixel_decoder=True, subpixel_impl='pallas').

Counterpart of `v2ce_toolbox_tpu/ops/decoder_pallas.py:fused_up_concat_conv`,
with its layout, asserts and rounding points. The weight fold
(`fold_decoder_kernel`), the skip fold (`fold_skip`), the concat and the
odd-size boundary corrections are plain torch, as they are plain XLA
there; only `_fused_conv_even` is a kernel: on a CPU tensor it runs its
plain twin, on a CUDA tensor it launches `csrc/decoder_conv.cu`, or
raises.

A 3x3 conv of a 2x nearest-upsampled image touches at most 2x2 coarse
pixels per output, so per output H-parity p the conv is 3 (dl) x 2 (coarse
row a) x 3 (coarse column db) taps over the folded input [coarse | skip
parities (alpha, beta, cs)], with both output W-parities (and the
projection) side by side in N.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.conv3d import DTYPES, check_inputs, gemm_args, kernel_operand

launches = {"fused_up_concat_conv": 0}

# Fold matrices F[p][dh, a]: K'_p[a] = sum_dh F[p][dh, a] * K[dh]. p = 0
# folds the taps (K0 | K1 + K2) over coarse rows (i-1, i); p = 1 folds
# (K0 + K1 | K2) over rows (i, i+1).
_F = ([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]],
      [[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


# The GEMM core's tile (BN, BK) for the folded weights: N holds Co-wide
# column blocks (output W-parity q, then the projection's) and K the coarse
# channels and the skip parities (alpha, beta) of Cs each, so a 64-wide N
# tile and a 32-channel K step line up with the fold's zero blocks, which
# the kernel's live-step pre-pass then skips (decoder_2 runs 0.630 and
# decoder_3 0.905 of the direct conv's multiply-adds, against 1.34x and
# 2.57x for the dense operand).
FOLD_TILES = (64, 32)


def _fold_matrices(device) -> list:
    return [torch.tensor(f, dtype=torch.float32, device=device) for f in _F]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def fold_decoder_kernel(kernel: torch.Tensor, cu: int,
                        proj_kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold a (3, 3, 3, Cu+Cs, Co) concat-conv kernel (and optionally the
    (1, 1, 1, Cu+Cs, Co) projection) for the coarse-grid conv, in f32.

    Returns kf (2, 3, 2, 3, Cu + 4*Cs, N): (output H-parity p, dl, a with
    coarse row offset p - 1 + a, db + 1); K rows are [coarse channels |
    skip (alpha, beta, cs)]; N columns are q-major (q * Co + co) for the
    conv, then the projection's q-major block.
    """
    cin, co = kernel.shape[-2:]
    cs = cin - cu
    k = kernel.float()
    ku, ks = k[..., :cu, :], k[..., cu:, :]
    n = 2 * co * (2 if proj_kernel is not None else 1)
    fm = _fold_matrices(kernel.device)

    kf = torch.zeros((2, 3, 2, 3, cu + 4 * cs, n), dtype=torch.float32, device=kernel.device)
    for p in (0, 1):
        for q in (0, 1):
            nlo = q * co
            # coarse (upsampled) branch: dy folded with F[p], dx with F[q];
            # F[q]'s two columns land at db = q - 1 + b
            kuf = torch.einsum("ha,wb,dhwio->dabio", fm[p], fm[q], ku)
            for a in (0, 1):
                for b in (0, 1):
                    db = q - 1 + b
                    kf[p, :, a, db + 1, :cu, nlo:nlo + co] += kuf[:, a, b]
            # skip branch: fine tap (dy, dx) lives at coarse offset (da, db)
            # and parity (alpha, beta), dy = 2 da + alpha - p
            for a in (0, 1):
                da = p - 1 + a
                for alpha in (0, 1):
                    dy = 2 * da + alpha - p
                    if not -1 <= dy <= 1:
                        continue
                    for db in (-1, 0, 1):
                        for beta in (0, 1):
                            dx = 2 * db + beta - q
                            if not -1 <= dx <= 1:
                                continue
                            klo = cu + alpha * 2 * cs + beta * cs
                            kf[p, :, a, db + 1, klo:klo + cs, nlo:nlo + co] += \
                                ks[:, dy + 1, dx + 1]
            # residual projection: one tap (centre dl, da = 0, db = 0) reads
            # coarse (i, j) and the skip's own (p, q) parity plane
            if proj_kernel is not None:
                kd = proj_kernel.float()[0, 0, 0]
                nplo = 2 * co + q * co
                kf[p, 1, 1 - p, 1, :cu, nplo:nplo + co] += kd[:cu]
                klo = cu + p * 2 * cs + q * cs
                kf[p, 1, 1 - p, 1, klo:klo + cs, nplo:nplo + co] += kd[cu:]
    return kf


def fold_skip(skip: torch.Tensor, hc: int, wc: int) -> torch.Tensor:
    """(B, L, hf, wf, Cs) -> (B, L, hc, wc, 4*Cs), channels (alpha, beta,
    cs); odd fine sizes are zero-padded, as the conv's 'same' padding."""
    b, l, hf, wf, cs = skip.shape
    skip = F.pad(skip, (0, 0, 0, 2 * wc - wf, 0, 2 * hc - hf))
    skip = skip.reshape(b, l, hc, 2, wc, 2 * cs).permute(0, 1, 2, 4, 3, 5)
    return skip.reshape(b, l, hc, wc, 4 * cs)


def _fused_conv_even_torch(x: torch.Tensor, kf: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of `fused_conv_even` (any device): the same 2 x 3 x 2 x 3
    tap products on the folded input, in f32."""
    b, l, hc, wc, _ = x.shape
    n = kf.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    kff = kf.float()
    out = torch.empty((b, l, hc, 2, wc, n), dtype=torch.float32, device=x.device)
    for p in (0, 1):
        acc = torch.zeros((b, l, hc, wc, n), dtype=torch.float32, device=x.device)
        for dl in range(3):
            for a in range(2):
                r0 = p + a          # padded row of coarse row offset p - 1 + a
                for db in range(3):
                    acc += torch.matmul(xp[:, dl:dl + l, r0:r0 + hc, db:db + wc],
                                        kff[p, dl, a, db])
        out[:, :, :, p] = acc
    return out.to(out_dtype)


def fused_conv_even(x: torch.Tensor, kf: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The coarse-grid conv (K10) on the folded input.

    Args:
      x: (B, L, hc, wc, K) folded input, float32 or bfloat16.
      kf: (2, 3, 2, 3, K, N) folded weights of x's dtype.
      out_dtype: float32 or bfloat16.
    Returns:
      (B, L, hc, 2, wc, N) in out_dtype, summed in f32: per output
      H-parity p, sum over (dl, a, db) of the shifted input times
      kf[p, dl, a, db].
    With bf16 inputs on the card the kernel skips every weight block that
    is all +-0, so an inf or NaN input that only such a block meets gives a
    finite output where the twin gives NaN (`csrc/conv_igemm.cuh`). The
    fold's own zero blocks never meet the input in the direct conv, so
    there this is the direct conv's answer.
    """
    if x.device.type == "cpu":
        return _fused_conv_even_torch(x, kf, out_dtype)
    check_inputs("fused_up_concat_conv", x, kf, out_dtype)
    if x.dim() != 5 or kf.shape[:4] != (2, 3, 2, 3) or kf.shape[4] != x.shape[4]:
        raise ValueError(f"fused_up_concat_conv: expected x (B, L, hc, wc, K) and kf "
                         f"(2, 3, 2, 3, K, N), got {tuple(x.shape)} and {tuple(kf.shape)}")
    b, l, hc, wc, k = x.shape
    n = kf.shape[-1]
    # weights as (parity, tap, N, K), tap = (dl * 2 + a) * 3 + db
    kt = kernel_operand(kf.reshape(2, 18, k, n).transpose(2, 3), 2, 3)
    xc = kernel_operand(x, 4)
    kp, np_ = xc.shape[4], kt.shape[2]
    out = torch.empty((b, l, hc, 2, wc, np_), dtype=out_dtype, device=x.device)
    live, live_bytes, bn, bk = gemm_args(x, 2, 18, kp, np_, FOLD_TILES)
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_decoder_conv(xc.data_ptr(), kt.data_ptr(), out.data_ptr(),
                                            live if live is None else live.data_ptr(),
                                            live_bytes, b, l, hc, wc, kp, np_, bn, bk,
                                            DTYPES[x.dtype], DTYPES[out_dtype],
                                            _cuda.stream_of(x))
    _cuda.check(err, "fused_up_concat_conv")
    launches["fused_up_concat_conv"] += 1
    return out if np_ == n else out[..., :n]


def _conv_f32(x: torch.Tensor, k: torch.Tensor, pads) -> torch.Tensor:
    """f32 conv of (B, L, H, W, C) by a (kd, kh, kw, C, Co) kernel with
    explicit (lo, hi) zero padding per (L, H, W) axis."""
    (l0, l1), (h0, h1), (w0, w1) = pads
    xn = F.pad(x.permute(0, 4, 1, 2, 3), (w0, w1, h0, h1, l0, l1))
    return F.conv3d(xn, k.permute(4, 3, 0, 1, 2)).permute(0, 2, 3, 4, 1)


def fused_up_concat_conv(coarse: torch.Tensor, skip: torch.Tensor, kernel: torch.Tensor,
                         proj_kernel: Optional[torch.Tensor] = None,
                         out_dtype: Optional[torch.dtype] = None):
    """conv3d(3x3x3, stride 1, 'same') of concat([nearest_up2(coarse)
    cropped to skip's (H, W), skip]) — the decoder block's conv1 — on the
    coarse grid, optionally with the residual 1x1x1 projection of the same
    concat input in the same GEMM.

    Args:
      coarse: (B, L, hc, wc, Cu); skip: (B, L, hf, wf, Cs) with hf in
        {2hc, 2hc-1}, wf in {2wc, 2wc-1}; both of one dtype.
      kernel: (3, 3, 3, Cu+Cs, Co), concat channel order (up | skip).
      proj_kernel: optional (1, 1, 1, Cu+Cs, Co), only where 4*Co <= 128.
        No bias: add it outside.
    Returns:
      (B, L, hf, wf, Co) in out_dtype (default coarse.dtype, f32
      accumulation), or a (conv_out, proj_out) pair with proj_kernel.
    """
    b, l, hc, wc, cu = coarse.shape
    hf, wf = skip.shape[2], skip.shape[3]
    assert hf in (2 * hc, 2 * hc - 1) and wf in (2 * wc, 2 * wc - 1), (
        coarse.shape, skip.shape)
    co = kernel.shape[-1]
    assert 2 * co <= 128, (
        f"fused decoder kernel supports Co <= 64 (one N tile); got {co}")
    assert proj_kernel is None or 4 * co <= 128, (
        f"projection fusion needs Co <= 32 (4*Co N lanes); got {co}")
    out_dtype = out_dtype or coarse.dtype

    # the folded weights round to the input dtype after the f32 fold
    kf = fold_decoder_kernel(kernel, cu, proj_kernel).to(coarse.dtype)
    x = torch.cat([coarse, fold_skip(skip, hc, wc)], dim=-1)
    out = fused_conv_even(x, kf, out_dtype)                 # (B, L, hc, 2, wc, N)
    proj = None
    if proj_kernel is not None:
        proj = out[..., 2 * co:].reshape(b, l, 2 * hc, 2 * wc, co)[:, :, :hf, :wf]
        out = out[..., :2 * co]
    fine = out.reshape(b, l, 2 * hc, 2 * wc, co)

    # Odd-size corrections (the up branch only; the zero-padded skip already
    # matches 'same' padding, and a 1x1 projection never reads a cropped
    # row): the fold took fine row 2hc-1 as coarse[hc-1], where 'same'
    # padding has zero. Computed in f32, added in the output dtype, on the
    # uncropped grid.
    ku = kernel.float()[..., :cu, :]
    fm = _fold_matrices(kernel.device)
    cf = coarse.float()
    odd_h, odd_w = hf == 2 * hc - 1, wf == 2 * wc - 1
    if odd_h:
        row = cf[:, :, hc - 1:hc]                           # (B, L, 1, wc, Cu)
        corr = [_conv_f32(row, torch.einsum("wb,dwio->dbio", fm[q], ku[:, 2])[:, None],
                          ((1, 1), (0, 0), (1, 0) if q == 0 else (0, 1)))[:, :, 0]
                for q in (0, 1)]                            # (B, L, wc, Co) each
        delta = torch.stack(corr, dim=3).reshape(b, l, 2 * wc, co)
        fine[:, :, 2 * hc - 2] += -delta.to(fine.dtype)
    if odd_w:
        col = cf[:, :, :, wc - 1:wc]                        # (B, L, hc, 1, Cu)
        corr = [_conv_f32(col, torch.einsum("ha,dhio->daio", fm[p], ku[:, :, 2])[:, :, None],
                          ((1, 1), (1, 0) if p == 0 else (0, 1), (0, 0)))[:, :, :, 0]
                for p in (0, 1)]                            # (B, L, hc, Co) each
        delta = torch.stack(corr, dim=3).reshape(b, l, 2 * hc, co)
        fine[:, :, :, 2 * wc - 2] += -delta.to(fine.dtype)
    if odd_h and odd_w:
        # the (dh=2, dw=2) term went twice, once per axis: add it back once
        corner = cf[:, :, hc - 1:hc, wc - 1:wc]
        cc = _conv_f32(corner, ku[:, 2, 2][:, None, None], ((1, 1), (0, 0), (0, 0)))
        fine[:, :, 2 * hc - 2, 2 * wc - 2] += cc[:, :, 0, 0].to(fine.dtype)

    fine = fine[:, :, :hf, :wf]
    return fine if proj is None else (fine, proj)
