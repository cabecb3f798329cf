"""K12: the 3x3x3 stride-1 'same' conv as Winograd F(4,3) over L and H,
the W taps folded into the product's N = 3*Co.

Counterpart of `v2ce_toolbox_tpu/ops/winograd_pallas.py:conv3d_wino4`, with
its layout (x (B, L, H, W, C), k (3, 3, 3, C, Co), f32 or bf16 in, f32
accumulation, `out_dtype` out) and its rounding points:
  * U = G k G^T over (dl, dh), in f32 (`filter_transform_lh`), then cast
    to x's dtype;
  * per 4x4 (L, H) output tile, the H transform E = BT x and then the L
    transform V = BT E in x's dtype: each product and each partial sum of
    a transform rounds to x's dtype, as the JAX kernel's arithmetic on
    bf16 arrays does (an f32 op, then the cast);
  * z = V . U[xi, lam], summed in f32;
  * the AT collapses over xi and lam, then the W-tap combine
    z[w, dw0] + z[w+1, dw1] + z[w+2, dw2], in f32; one cast to out_dtype.
The sums run in the JAX kernel's term order (`_lincomb`), so in f32 the
transforms and collapses round as the JAX kernel's do. A tile reads
padded rows 4J..4J+5 only, so the JAX kernel's (lt, th) blocks, which
pick its VMEM slab, do not change any output: they are checked and kept
for the probe's sweep, and the port tiles by 4.

`ablate` is the probe's cost attribution: 'nodot' replaces z by V's
leading 3*Co lanes of the JAX kernel's channel padding cp (`:231`), tiled
when cp < 3*Co, and is reproduced bit for bit in f32; 'noinv' raises, since
the JAX kernel's own 'noinv' raises (below).

On a CPU tensor `conv3d_wino4` runs the plain twin; on a CUDA tensor it
launches `csrc/wino4.cu` (input transform, the 36 products through the
implicit GEMM of `csrc/conv_igemm.cuh`, output transform), or raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.conv3d import CHANNEL_ALIGN, DTYPES, check_inputs

launches = {"conv3d_wino4": 0}

# F(4,3) transform matrices, interpolation points (0, 1, -1, 2, -2, inf)
# (copied from winograd_pallas.py:47-68)
BT4 = np.array([
    [4, 0, -5, 0, 1, 0],
    [0, -4, -4, 1, 1, 0],
    [0, 4, -4, -1, 1, 0],
    [0, -2, -1, 2, 1, 0],
    [0, 2, -1, -2, 1, 0],
    [0, 4, 0, -5, 0, 1],
], np.float32)
G4 = np.array([
    [1 / 4, 0, 0],
    [-1 / 6, -1 / 6, -1 / 6],
    [-1 / 6, 1 / 6, -1 / 6],
    [1 / 24, 1 / 12, 1 / 6],
    [1 / 24, -1 / 12, 1 / 6],
    [0, 0, 1],
], np.float32)
AT4 = np.array([
    [1, 1, 1, 1, 1, 0],
    [0, 1, -1, 2, -2, 0],
    [0, 1, 1, 4, 4, 0],
    [0, 1, -1, 8, -8, 1],
], np.float32)
_M = 4                          # outputs per 1-D tile
ABLATE = {"full": 0, "nodot": 1}
NOINV_FAULT = ("conv3d_wino4: ablate='noinv' is not ported: the JAX kernel's own 'noinv' "
               "raises (winograd_pallas.py:157-159 leaves p[a] None for the collapse at "
               ":167-174, TypeError)")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def filter_transform_lh(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> U (6, 6, C, 3*Co) in f32: U[xi, lam, :, (dw, co)] =
    sum_{dl, dh} G[xi, dl] G[lam, dh] k[dl, dh, dw] (`winograd_pallas.py:196`)."""
    g = torch.from_numpy(G4).to(k.device)
    u = torch.einsum("xa,yb,abwio->xyiwo", g, g, k.float())
    return u.reshape(6, 6, k.shape[3], 3 * k.shape[4])


def channel_pad(c: int) -> int:
    """The JAX kernel's channel padding cp (`winograd_pallas.py:231`)."""
    return -(-c // 128) * 128 if c > 8 else -(-c // 8) * 8


def nodot_lanes(c: int, co: int) -> list:
    """For each of the 3*Co lanes of 'nodot''s fake z, the channel of V it
    copies, or -1 where it copies the JAX kernel's zero channel padding."""
    cp = channel_pad(c)
    src = [j if cp >= 3 * co else j % cp for j in range(3 * co)]
    return [s if s < c else -1 for s in src]


def _lincomb(terms, coeffs, dtype=torch.float32):
    """sum_i coeffs[i] * terms[i] of f32 tensors in the JAX kernel's order
    (`_lincomb`, `winograd_pallas.py:75`): zeros skipped, +-1 folded, left
    to right, every product and partial sum rounded to `dtype`."""
    def rnd(t):
        return t if dtype == torch.float32 else t.to(dtype).float()

    out = None
    for t, cf in zip(terms, coeffs):
        if cf == 0:
            continue
        term = t if cf == 1 else (-t if cf == -1 else rnd(t * float(cf)))
        out = term if out is None else rnd(out + term)
    return out


def _accumulate(acc, t, cf):
    """acc + cf * t as the JAX kernel's collapses add it (`:161-174`)."""
    term = _lincomb([t], [cf])
    return acc if term is None else (term if acc is None else acc + term)


def _check(x: torch.Tensor, k: torch.Tensor, lt: int, th: int, ablate: str) -> None:
    if ablate == "noinv":
        raise ValueError(NOINV_FAULT)
    if ablate not in ABLATE:
        raise ValueError(f"conv3d_wino4: ablate={ablate!r}, expected 'full' or 'nodot'")
    if lt % _M or th % _M or lt < _M or th < _M:
        raise ValueError(f"conv3d_wino4: lt={lt}, th={th} must be positive multiples of 4")
    if x.dim() != 5 or tuple(k.shape[:3]) != (3, 3, 3) or k.dim() != 5 \
            or k.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_wino4: expected x (B, L, H, W, C) and k (3, 3, 3, C, Co), "
                         f"got {tuple(x.shape)} and {tuple(k.shape)}")


def _conv3d_wino4_torch(x: torch.Tensor, k: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32, lt: int = 8, th: int = 8,
                        ablate: str = "full") -> torch.Tensor:
    """Plain twin of `conv3d_wino4` (any device), the same rounding points."""
    _check(x, k, lt, th, ablate)
    b, l, h, w, c = x.shape
    co = k.shape[4]
    cdt = x.dtype
    nl, nh = -(-l // _M), -(-h // _M)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, _M * nh + 1 - h, 1, _M * nl + 1 - l))
    u = filter_transform_lh(k).to(cdt).float()
    if ablate == "nodot":
        lanes = torch.tensor(nodot_lanes(c, co), device=x.device)
        pad_lane = lanes < 0
        lanes = lanes.clamp(min=0)
    e_terms = [xp[:, :, bb:bb + _M * nh:_M] for bb in range(6)]
    y = [[None] * _M for _ in range(_M)]
    for lam in range(6):
        e = _lincomb(e_terms, BT4[lam], cdt)                   # (b, 4nl+2, nh, w+2, c)
        v_terms = [e[:, aa:aa + _M * nl:_M] for aa in range(6)]
        p = [None] * _M
        for xi in range(6):
            v = _lincomb(v_terms, BT4[xi], cdt)                # (b, nl, nh, w+2, c)
            if ablate == "nodot":
                z = torch.where(pad_lane, 0.0, v[..., lanes])
            else:
                z = torch.matmul(v, u[xi, lam])                 # (b, nl, nh, w+2, 3co)
            for a in range(_M):
                p[a] = _accumulate(p[a], z, AT4[a, xi])
        for a in range(_M):
            for bh in range(_M):
                y[a][bh] = _accumulate(y[a][bh], p[a], AT4[bh, lam])
    out = torch.empty((b, nl, _M, nh, _M, w, co), dtype=torch.float32, device=x.device)
    for a in range(_M):
        for bh in range(_M):
            ya = y[a][bh]
            out[:, :, a, :, bh] = (ya[..., 0:w, 0:co] + ya[..., 1:w + 1, co:2 * co]
                                   + ya[..., 2:w + 2, 2 * co:3 * co])
    return out.reshape(b, _M * nl, _M * nh, w, co)[:, :l, :h].to(out_dtype)


def conv3d_wino4(x: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                 lt: int = 8, th: int = 8, ablate: str = "full") -> torch.Tensor:
    """3x3x3 stride-1 'same' conv via Winograd F(4,3) over L and H (K12).

    Args:
      x: (B, L, H, W, C) activations, float32 or bfloat16.
      k: (3, 3, 3, C, Co) filter of x's dtype.
      out_dtype: float32 or bfloat16.
      lt, th: the JAX kernel's output frames / rows per block, positive
        multiples of 4; they do not change the result.
      ablate: 'full', or 'nodot' (z faked from V, see the module doc);
        'noinv' raises ValueError.
    Returns:
      (B, L, H, W, Co) in out_dtype.
    """
    _check(x, k, lt, th, ablate)
    if x.device.type == "cpu":
        return _conv3d_wino4_torch(x, k, out_dtype, lt, th, ablate)
    check_inputs("conv3d_wino4", x, k, out_dtype)
    b, l, h, w, c = x.shape
    co = k.shape[4]
    nl, nh = -(-l // _M), -(-h // _M)
    cv = -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN
    n = 3 * co
    npad = -(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN
    m = b * nl * nh * (w + 2)            # rows of each of the 36 products
    if m >= 1 << 31 or b * l * h * w >= 1 << 31:
        raise ValueError(f"conv3d_wino4: {tuple(x.shape)} exceeds the kernel's limits")
    # U as (36, N, C) in x's dtype: every GEMM row contiguous, zero padded
    ut = filter_transform_lh(k).to(x.dtype).permute(0, 1, 3, 2).reshape(36, n, c)
    ut = F.pad(ut, (0, cv - c, 0, npad - n)).contiguous()
    xc = x.contiguous()
    v = torch.empty((36, m, cv), dtype=x.dtype, device=x.device)
    z = torch.empty((36, m, npad), dtype=torch.float32, device=x.device)
    lanes = (torch.tensor(nodot_lanes(c, co), dtype=torch.int32, device=x.device)
             if ablate == "nodot" else None)
    out = torch.empty((b, l, h, w, co), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d_wino4(
            xc.data_ptr(), ut.data_ptr(), v.data_ptr(), z.data_ptr(),
            lanes.data_ptr() if lanes is not None else None,
            out.data_ptr(), b, l, h, w, c, cv, co, npad, ABLATE[ablate],
            DTYPES[x.dtype], DTYPES[out_dtype], _cuda.stream_of(x))
    _cuda.check(err, "conv3d_wino4")
    launches["conv3d_wino4"] += 1
    return out
