"""W-packed conv3d, the port of `v2ce_toolbox_tpu/ops/wpack.py`, on NCDHW
tensors: the width-axis taps fold into the channels.

Output width is grouped into quads of ws = 128 // min(Co, 128) positions
and the conv becomes

    out[l, h, q, (s, co)] = sum_{dl, dh} xT[l+dl, h+dh, q] @ W'[dl, dh]

where xT[.., q, (j, c)] = x[.., q*ws*sw + j - 1, c] is the (ws-1)*sw + 3
tap width window of quad q (sw the W stride) and W'[dl, dh, (j, c), (s,
co)] holds the 3 genuine dw taps of each output phase s (zeros elsewhere):
one (3, 3, 1) conv of (taps*C) -> ws*Co channels, W no longer convolved.
ws = 1 is multiply-add neutral, ws = 2 costs 4/3 and ws = 4 2x. Plain
torch, so it is differentiable.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _pick_ws(co: int) -> int:
    if co >= 128:
        return 1
    return max(1, 128 // co)


@functools.lru_cache(maxsize=None)
def _weight_index(kw: int, ws: int, sw: int, taps: int) -> np.ndarray:
    """(taps, ws) map: the dw tap of (window tap j, phase s), or -1.

    Output position w = q*ws*sw + s*sw reads inputs w + dw - 1 for dw in
    [0, kw); window tap j covers input q*ws*sw + (j - 1). So j = s*sw + dw,
    valid iff 0 <= j - s*sw < kw.
    """
    idx = np.full((taps, ws), -1, np.int64)
    for s in range(ws):
        for dw in range(kw):
            idx[s * sw + dw, s] = dw
    return idx


def pack_weights(k: torch.Tensor, ws: int, sw: int = 1) -> torch.Tensor:
    """(Co, C, kl, kh, kw) -> (ws*Co, taps*C, kl, kh, 1) packed kernel,
    output channel s*Co + co, input channel j*C + c."""
    co, c, kl, kh, kw = k.shape
    taps = (ws - 1) * sw + kw
    idx = torch.from_numpy(_weight_index(kw, ws, sw, taps)).to(k.device)
    kz = F.pad(k, (0, 1))                    # index -1 -> the zero plane
    w = kz[..., idx]                         # (Co, C, kl, kh, taps, ws)
    w = w.permute(5, 0, 4, 1, 2, 3)          # (ws, Co, taps, C, kl, kh)
    return w.reshape(ws * co, taps * c, kl, kh, 1)


def pack_input(x: torch.Tensor, ws: int, sw: int = 1,
               kw: int = 3) -> Tuple[torch.Tensor, int]:
    """(B, C, L, H, W) -> ((B, taps*C, L, H, nq) width windows, w_out), where
    w_out = ceil(W / sw) is the output width before the quad padding and
    nq = ceil(w_out / ws)."""
    w = x.shape[-1]
    w_out = -(-w // sw)
    nq = -(-w_out // ws)
    taps = (ws - 1) * sw + kw
    # input q*ws*sw + (j-1), q in [0, nq), j in [0, taps), stays in range
    # after the left pad of 1
    w_need = (nq - 1) * ws * sw + taps - 1
    xp = F.pad(x, (1, max(w_need - w, 1)))
    cols = [xp[..., j:j + (nq - 1) * ws * sw + 1:ws * sw] for j in range(taps)]
    return torch.cat(cols, dim=1), w_out


def conv3d_wpack(x: torch.Tensor, k: torch.Tensor,
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 compute_dtype: torch.dtype = torch.float32,
                 ws: Optional[int] = None) -> torch.Tensor:
    """The 'same'-padded conv3d of a 3x3x3 kernel by width packing
    (`wpack.py:110`): equal to F.conv3d(x, k, stride, padding=1) up to the
    order of the f32 sums.

    x: (B, C, L, H, W); k: (Co, C, 3, 3, 3); strides (sl, sh, sw), sl 1.
    Returns (B, Co, L, H_out, W_out) float32.
    """
    co, _, kl, kh, kw = k.shape
    sl, sh, sw = strides
    assert sl == 1, "temporal stride unsupported"
    if ws is None:
        ws = _pick_ws(co)
    xt, w_out = pack_input(x.to(compute_dtype), ws, sw, kw)
    wp = pack_weights(k.to(compute_dtype), ws, sw)
    out = F.conv3d(xt, wp, stride=(1, sh, 1),
                   padding=(kl // 2, kh // 2, 0)).float()   # (B, ws*Co, L, H_out, nq)
    b, _, l, h_out, nq = out.shape
    out = out.reshape(b, ws, co, l, h_out, nq).permute(0, 2, 3, 4, 5, 1)
    return out.reshape(b, co, l, h_out, nq * ws)[..., :w_out]
