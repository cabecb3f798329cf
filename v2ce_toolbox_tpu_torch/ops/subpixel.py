"""Sub-pixel (folded-kernel) convolution over nearest-upsampled inputs, the
port of `v2ce_toolbox_tpu/ops/subpixel.py`, on NCDHW tensors.

The UNet decoder computes `conv3d_3x3x3(concat(nearest_up2(coarse), skip))`.
A conv distributes over a channel concat, and a 3x3 conv of a 2x
nearest-upsampled image reads at most 2x2 distinct coarse pixels per
output, so the upsampled branch can be computed on the coarse grid with
folded kernels: the same function up to float reassociation, with 4/9 of
the branch's multiply-adds in the 'split' form.

Per spatial axis, fine index y = 2i + p, 'same' padding:
  out[2i]   = coarse[i-1]*K0 + coarse[i]*(K1+K2)          (p=0 fold)
  out[2i+1] = coarse[i]*(K0+K1) + coarse[i+1]*K2          (p=1 fold)
An odd target (2h-1) crops the last upsampled row. Only the last p=0 row
read past it, where its K2 tap met a zero: a rank-1 boundary correction
removes that term, and where both axes are odd the corner, removed once
per axis, is added back once.

Kernels are torch's (Co, C, kd, kh, kw); every function returns f32, its
convs run in the dtype of its inputs (a bf16 conv rounds its sums to bf16
before the cast, as `models/layers._apply_conv`'s do).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# fold matrices F[p][dh, a]: K'_p[a] = sum_dh F[p][dh, a] * K[dh]
_F0 = np.array([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]])   # rows (i-1, i)
_F1 = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])   # rows (i, i+1)
# 'same' padding per parity: p=0 needs coarse row i-1 -> pad before
_PAD = {0: (1, 0), 1: (0, 1)}
_SAME = (1, 1)
_NONE = (0, 0)


def _conv(x: torch.Tensor, k: torch.Tensor,
          pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """F.conv3d of x by k with (before, after) zero padding on L, H and W,
    f32 out. An uneven pair is padded evenly by its larger side and the
    extra output row cropped, so the input is never copied."""
    sym = tuple(max(p) for p in pads)
    y = F.conv3d(x, k, padding=sym).float()
    for axis, ((lo, hi), s) in enumerate(zip(pads, sym)):
        if lo != hi:
            n = x.shape[2 + axis] + lo + hi - k.shape[2 + axis] + 1
            y = y.narrow(2 + axis, s - lo, n)
    return y


def _fold_mats(k: torch.Tensor):
    return [torch.as_tensor(_F0, dtype=k.dtype, device=k.device),
            torch.as_tensor(_F1, dtype=k.dtype, device=k.device)]


def _check(coarse: torch.Tensor, target_hw) -> Tuple[bool, bool]:
    hc, wc = coarse.shape[-2:]
    th, tw = target_hw
    assert th in (2 * hc, 2 * hc - 1) and tw in (2 * wc, 2 * wc - 1), (
        tuple(coarse.shape), target_hw)
    return th == 2 * hc - 1, tw == 2 * wc - 1


def _wq_fold(k: torch.Tensor) -> torch.Tensor:
    """The W fold with q in the output channels: (Co, C, kd, kh, 3) ->
    (2Co, C, kd, kh, 3), each extent-2 fold zero-embedded at extent 3 so
    one 'same'-padded conv serves both alignments:
    q=0: taps (b=-1: K0, b=0: K1+K2); q=1: (b=0: K0+K1, b=+1: K2)."""
    z = torch.zeros_like(k[..., :1])
    kq0 = torch.cat([k[..., :1], (k[..., 1] + k[..., 2]).unsqueeze(-1), z], dim=-1)
    kq1 = torch.cat([z, (k[..., 0] + k[..., 1]).unsqueeze(-1), k[..., 2:]], dim=-1)
    return torch.cat([kq0, kq1], dim=0)


def _hp_fold(k: torch.Tensor):
    """The H fold of (.., kh=3, kw) zero-embedded at extent 3: (p=0, p=1)."""
    z = torch.zeros_like(k[..., :1, :])
    kp0 = torch.cat([k[..., :1, :], (k[..., 1, :] + k[..., 2, :]).unsqueeze(-2), z], dim=-2)
    kp1 = torch.cat([z, (k[..., 0, :] + k[..., 1, :]).unsqueeze(-2), k[..., 2:, :]], dim=-2)
    return kp0, kp1


def conv3d_on_nearest_up2(coarse: torch.Tensor, kernel: torch.Tensor,
                          target_hw: Tuple[int, int]) -> torch.Tensor:
    """conv3d(kernel 3x3x3, stride 1, 'same') of
    `nearest_up2(coarse)[..., :H, :W]`, as four folded (3, 2, 2) convs on
    the coarse grid ('split'; `subpixel.py:45`).

    Args:
      coarse: (B, C, L, hc, wc); kernel: (Co, C, 3, 3, 3).
      target_hw: (H, W) with H in {2*hc, 2*hc - 1}, the same for W.
    Returns:
      (B, Co, L, H, W) float32.
    """
    odd_h, odd_w = _check(coarse, target_hw)
    b, _, l, hc, wc = coarse.shape
    fh = _fold_mats(kernel)
    outs = {}
    for p in (0, 1):
        for q in (0, 1):
            kf = torch.einsum("ha,wb,oidhw->oidab", fh[p], fh[q], kernel)
            outs[(p, q)] = _conv(coarse, kf, (_SAME, _PAD[p], _PAD[q]))
    if odd_h:
        # the last p=0 row read a zero where the fold assumed coarse[hc-1]:
        # remove the dh=2 tap's term (w still folded per q)
        row = coarse[..., hc - 1:hc, :]
        for q in (0, 1):
            k2 = torch.einsum("wb,oidw->oidb", fh[q], kernel[:, :, :, 2]).unsqueeze(3)
            outs[(0, q)][..., hc - 1:hc, :] -= _conv(row, k2, (_SAME, _NONE, _PAD[q]))
    if odd_w:
        col = coarse[..., wc - 1:wc]
        for p in (0, 1):
            k2 = torch.einsum("ha,oidh->oida", fh[p], kernel[..., 2]).unsqueeze(4)
            outs[(p, 0)][..., wc - 1:wc] -= _conv(col, k2, (_SAME, _PAD[p], _NONE))
    if odd_h and odd_w:
        # the corner was removed once per axis: add the (dh=2, dw=2) term back once
        corner = coarse[..., hc - 1:hc, wc - 1:wc]
        outs[(0, 0)][..., hc - 1:, wc - 1:] += _conv(corner, kernel[..., 2:, 2:],
                                                     (_SAME, _NONE, _NONE))
    # fine[.., 2i+p, 2j+q] = outs[(p, q)][.., i, j]
    co = kernel.shape[0]
    fine = torch.stack([outs[(p, q)] for p in (0, 1) for q in (0, 1)], dim=-1)
    fine = fine.reshape(b, co, l, hc, wc, 2, 2).permute(0, 1, 2, 3, 5, 4, 6)
    fine = fine.reshape(b, co, l, 2 * hc, 2 * wc)
    return fine[..., :target_hw[0], :target_hw[1]]


def conv3d_on_nearest_up2_pfold(coarse: torch.Tensor, kernel: torch.Tensor,
                                target_hw: Tuple[int, int]) -> torch.Tensor:
    """The contract of :func:`conv3d_on_nearest_up2`, with both output
    parities in the output channels of one (3, 3, 3) conv on the coarse
    grid ('pfold'; `subpixel.py:103`): the folded per-parity kernels are
    zero-embedded in one kernel of 4*Co outputs, channel p*2Co + q*Co + co
    for fine pixel (2i+p, 2j+q) at coarse (i, j). Odd targets get the
    rank-1 corrections on the coarse output's channel slices; the parity
    interleave is one reshape and permute."""
    odd_h, odd_w = _check(coarse, target_hw)
    b, _, l, hc, wc = coarse.shape
    co = kernel.shape[0]
    kw = _wq_fold(kernel)                               # (2Co, C, 3, 3, 3)
    kf = torch.cat(_hp_fold(kw), dim=0)                 # (4Co, C, 3, 3, 3)
    out = _conv(coarse, kf, (_SAME, _SAME, _SAME))      # (B, 4Co, L, hc, wc)
    if odd_w:
        # q=0's b=0 tap folded K2, but the fine column 2wc-1 it came from is
        # cropped: subtract K2 * coarse[wc-1] from the q=0 quarter of each
        # p half (H-folded like kf)
        k2p0, k2p1 = _hp_fold(kernel[..., 2:])          # (Co, C, 3, 3, 1) each
        col = coarse[..., wc - 1:wc]
        c0 = _conv(col, k2p0, (_SAME, _SAME, _NONE))[..., 0]
        c1 = _conv(col, k2p1, (_SAME, _SAME, _NONE))[..., 0]
        out[:, 0:co, :, :, wc - 1] -= c0
        out[:, 2 * co:3 * co, :, :, wc - 1] -= c1
    if odd_h:
        # p=0's dh=0 tap folded K[2]; the fine row 2hc-1 is cropped: subtract
        # the W-folded K[2] row term from the whole p=0 half
        row = coarse[..., hc - 1:hc, :]
        ch = _conv(row, kw[:, :, :, 2:3], (_SAME, _NONE, _SAME))[..., 0, :]
        out[:, 0:2 * co, :, hc - 1] -= ch
    if odd_h and odd_w:
        corner = coarse[..., hc - 1:hc, wc - 1:wc]
        cc = _conv(corner, kernel[..., 2:, 2:], (_SAME, _NONE, _NONE))[..., 0, 0]
        out[:, 0:co, :, hc - 1, wc - 1] += cc
    out = out.reshape(b, 2, 2, co, l, hc, wc).permute(0, 3, 4, 5, 1, 6, 2)
    out = out.reshape(b, co, l, 2 * hc, 2 * wc)
    return out[..., :target_hw[0], :target_hw[1]]


def conv3d_on_nearest_up2_wfold(coarse: torch.Tensor, kernel: torch.Tensor,
                                target_hw: Tuple[int, int]) -> torch.Tensor:
    """Between the split and pfold forms ('wfold'; `subpixel.py:196`): the
    W parity rides the output channels (2*Co) while the H parity keeps the
    split form's two extent-2 convs."""
    odd_h, odd_w = _check(coarse, target_hw)
    b, _, l, hc, wc = coarse.shape
    co = kernel.shape[0]
    fh = _fold_mats(kernel)
    kw = _wq_fold(kernel)                               # (2Co, C, 3, 3, 3)
    outs = []
    for p in (0, 1):
        kf = torch.einsum("ha,oidhw->oidaw", fh[p], kw)  # (2Co, C, 3, 2, 3)
        outs.append(_conv(coarse, kf, (_SAME, _PAD[p], _SAME)))
    if odd_w:
        col = coarse[..., wc - 1:wc]
        for p in (0, 1):
            k2f = torch.einsum("ha,oidh->oida", fh[p], kernel[..., 2]).unsqueeze(4)
            corr = _conv(col, k2f, (_SAME, _PAD[p], _NONE))[..., 0]
            outs[p][:, 0:co, :, :, wc - 1] -= corr
    if odd_h:
        corr = _conv(coarse[..., hc - 1:hc, :], kw[:, :, :, 2:3], (_SAME, _NONE, _SAME))
        outs[0][:, :, :, hc - 1] -= corr[..., 0, :]
    if odd_h and odd_w:
        corner = coarse[..., hc - 1:hc, wc - 1:wc]
        cc = _conv(corner, kernel[..., 2:, 2:], (_SAME, _NONE, _NONE))[..., 0, 0]
        outs[0][:, 0:co, :, hc - 1, wc - 1] += cc
    # (B, (q, Co), p, L, hc, wc) -> (B, Co, L, hc, p, wc, q)
    out = torch.stack(outs, dim=2).reshape(b, 2, co, 2, l, hc, wc)
    out = out.permute(0, 2, 4, 5, 3, 6, 1).reshape(b, co, l, 2 * hc, 2 * wc)
    return out[..., :target_hw[0], :target_hw[1]]


def conv1x1_on_nearest_up2(coarse: torch.Tensor, kernel: torch.Tensor,
                           target_hw: Tuple[int, int]) -> torch.Tensor:
    """A 1x1x1 conv commutes with nearest upsampling: the conv on the
    coarse grid, then each pixel repeated 2x2 and cropped (`subpixel.py:249`;
    exact, a 1x1 kernel never reads the cropped row). kernel: (Co, C, 1, 1, 1)."""
    y = F.conv3d(coarse, kernel).float()
    b, co, l, hc, wc = y.shape
    y = y[:, :, :, :, None, :, None].expand(b, co, l, hc, 2, wc, 2)
    return y.reshape(b, co, l, 2 * hc, 2 * wc)[..., :target_hw[0], :target_hw[1]]
