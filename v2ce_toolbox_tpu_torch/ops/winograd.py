"""Winograd F(2x2,3x3) 3x3x3 convolution in plain torch, the port of
`v2ce_toolbox_tpu/ops/winograd.py` (its formulation, not a kernel; the
`winograd` probe is its one caller). Distinct from K12
(`ops/conv3d_wino4.py`, F(4,3) on L and H in one kernel).

    out[l] = sum_dl conv2d_wino(x[l+dl-1], k[dl])

with the temporal taps folded into the matmul's N = 3*Co: one
transform-domain product per (xi, nu) tile position gives all three
temporal partials, shift-added over l in the transform domain (the inverse
transform is linear). Transforms (Lavin & Gray 2015, arXiv:1509.09308):

    V = BT d B   (4x4 input tile, stride-2 tiling of the padded input)
    U = G g GT   (per temporal tap)
    M = V @ U    (contraction over C, `torch.matmul`)
    Y = AT M A   (2x2 output tile)

Every coefficient is 0, +-1 or +-1/2, exact in bf16. Tensors are
channels-last, as in the JAX module: x (B, L, H, W, C), k (3, 3, 3, C, Co).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BT = np.array([[1, 0, -1, 0],
               [0, 1, 1, 0],
               [0, -1, 1, 0],
               [0, 1, 0, -1]], np.float32)
G = np.array([[1, 0, 0],
              [0.5, 0.5, 0.5],
              [0.5, -0.5, 0.5],
              [0, 0, 1]], np.float32)
AT = np.array([[1, 1, 1, 0],
               [0, 1, -1, -1]], np.float32)


def filter_transform(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> U (4, 4, 3, C, Co): U[.., dl] = G k[dl] GT over
    the two spatial tap axes (dh, dw)."""
    g = torch.as_tensor(G, dtype=k.dtype, device=k.device)
    return torch.einsum("xa,yb,tabio->xytio", g, g, k)


def _row(vals, coefs):
    """sum coef * v over the nonzero coefficients, in order (+-1 as a sign)."""
    out = None
    for coef, v in zip(coefs, vals):
        if coef == 0:
            continue
        term = v if coef == 1 else (-v if coef == -1 else coef * v)
        out = term if out is None else out + term
    return out


def input_transform(xp: torch.Tensor) -> torch.Tensor:
    """Padded input (B, L, 2nh + 2, 2nw + 2, C) -> V (4, 4, B, L, nh, nw, C):
    d[a, b][i, j] = xp[2i + a, 2j + b], V = BT d B as four-term +-sums of
    the 16 strided views."""
    nh, nw = (xp.shape[2] - 2) // 2, (xp.shape[3] - 2) // 2
    d = [[xp[:, :, a:a + 2 * nh:2, bb:bb + 2 * nw:2, :] for bb in range(4)]
         for a in range(4)]
    # e[xi][b] = sum_a BT[xi, a] d[a][b]; V[xi][nu] = sum_b BT[nu, b] e[xi][b]
    e = [[_row([d[a][bb] for a in range(4)], BT[xi]) for bb in range(4)] for xi in range(4)]
    v = [[_row(e[xi], BT[nu]) for nu in range(4)] for xi in range(4)]
    return torch.stack([torch.stack(vr, 0) for vr in v], 0)


def output_transform(m: torch.Tensor) -> torch.Tensor:
    """M (4, 4, B, L, nh, nw, Co) -> (B, L, 2nh, 2nw, Co): Y = AT M A, the
    2x2 tiles interleaved back onto the pixel grid."""
    p = [[_row([m[xi, nu] for xi in range(4)], AT[a]) for nu in range(4)] for a in range(2)]
    y = [[_row(p[a], AT[bb]) for bb in range(2)] for a in range(2)]
    t = torch.stack([torch.stack([y[a][0], y[a][1]], dim=4) for a in range(2)], dim=3)
    b, l, nh, _, nw, _, co = t.shape                 # (B, L, nh, 2, nw, 2, Co)
    return t.reshape(b, l, 2 * nh, 2 * nw, co)


def conv3d_winograd(x: torch.Tensor, k: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3x3 stride-1 'same' conv by spatial Winograd F(2x2,3x3).

    Args:
      x: (B, L, H, W, C); k: (3, 3, 3, C, Co), taps (dl, dh, dw).
    Returns:
      (B, L, H, W, Co) float32. The transforms and products run in
      compute_dtype (a bf16 product rounds to bf16 before the f32 cast).
    """
    b, l, h, w, c = x.shape
    co = k.shape[-1]
    nh, nw = -(-h // 2), -(-w // 2)
    # pad to an even tiling plus the conv's own 'same' halo of 1
    xp = F.pad(x.to(compute_dtype), (0, 0, 1, 1 + 2 * nw - w, 1, 1 + 2 * nh - h))
    v = input_transform(xp)                          # (4, 4, B, L, nh, nw, C)
    u = filter_transform(k.to(compute_dtype))        # (4, 4, 3, C, Co)
    # one product per (xi, nu): N = 3*Co, the temporal taps in the columns
    u3 = u.permute(0, 1, 3, 2, 4).reshape(16, c, 3 * co)
    z = torch.matmul(v.reshape(16, -1, c), u3).float()
    z = z.reshape(4, 4, b, l, nh, nw, 3, co)
    # M[l] = Z[l-1, dl=0] + Z[l, dl=1] + Z[l+1, dl=2] (zero outside)
    m = z[..., 1, :].clone()
    m[:, :, :, 1:] += z[:, :, :, :-1, ..., 0, :]
    m[:, :, :, :-1] += z[:, :, :, 1:, ..., 2, :]
    return output_transform(m)[:, :, :h, :w]
