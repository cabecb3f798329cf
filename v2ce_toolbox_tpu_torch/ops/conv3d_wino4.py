"""K12: the 3x3x3 stride-1 'same' conv as Winograd F(4,3) over L and H,
the W taps folded into the product's N = 3*Co (the twin, the three-launch
route) or into its reduction (the fused bf16 route).

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
launches `csrc/wino4.cu`, or raises. bf16 inputs with ablate='full' take
the fused route: the input transform writes V, then one kernel runs the
36 products on wgmma and the collapses in registers, so Z never reaches
device memory; it adds the three W taps inside each product (dw first),
where the twin adds them after the collapses: the same function summed in
another order, inside the f32 tolerance. f32 inputs and ablate='nodot'
take the three-launch route (input transform, the 36 products Z through
the f32 implicit GEMM of `csrc/conv_igemm.cuh` or 'nodot''s lane copy,
output transform), so 'nodot' times that route, not the fused one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.conv3d import (CHANNEL_ALIGN, DTYPES, check_inputs, gemm_args,
                                                kernel_operand)

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
# the fused bf16 kernel's block (csrc/wino4.cu): 64 output W positions (one
# m64 wgmma tile) x 32 output channels; a ring of stages, each one box of 72
# V rows (the three dw taps read rows dw .. dw + 63) in a 1024-byte aligned
# region and three U boxes, in 160 KB of shared memory, at most 12; the f32
# register sets of a consumer thread (z, two step sums, two p, four of its
# eight y; 16 registers each) and the four y sets it parks in shared
# memory; its static shared memory (24 mbarriers)
FUSED_ROWS, FUSED_BN, FUSED_AROWS = 64, 32, 72
FUSED_RING_BYTES, FUSED_MAX_STAGES = 160 * 1024, 12
FUSED_SETS, FUSED_PARKED_SETS = 9, 4
FUSED_STATIC_SMEM = 24 * 8
SMEM_LIMIT = 227 * 1024         # a block's shared memory on sm_90
CONSUMER_REGISTERS = 232        # the consumer warpgroups' setmaxnreg
ABLATE = {"full": 0, "nodot": 1}
NOINV_FAULT = ("conv3d_wino4: ablate='noinv' is not ported: the JAX kernel's own 'noinv' "
               "raises (winograd_pallas.py:157-159 leaves p[a] None for the collapse at "
               ":167-174, TypeError)")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_G4_ON = {}                     # device -> G4 there


def _g4(device: torch.device) -> torch.Tensor:
    """G4 on `device`, copied there once: a call then makes no host copy,
    which would wait for the stream and cannot be captured in a CUDA graph."""
    if device not in _G4_ON:
        _G4_ON[device] = torch.from_numpy(G4).to(device)
    return _G4_ON[device]


def filter_transform_lh(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, Co) -> U (6, 6, C, 3*Co) in f32: U[xi, lam, :, (dw, co)] =
    sum_{dl, dh} G[xi, dl] G[lam, dh] k[dl, dh, dw] (`winograd_pallas.py:196`)."""
    g = _g4(k.device)
    # over dl, then dh: the order opt_einsum picks for the three-operand
    # einsum (and XLA for the JAX function), without its path search a call
    u = torch.einsum("yb,xbwio->xyiwo", g, torch.einsum("xa,abwio->xbwio", g, k.float()))
    return u.reshape(6, 6, k.shape[3], 3 * k.shape[4])


def gemm_weights(k: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U as the fused kernel reads it, the conv core's wt[p, t, n, c]
    layout: (36, 3, Co, C) with [6 xi + lam, dw, co, c] =
    `filter_transform_lh(k)`[xi, lam, c, dw * Co + co], computed in f32 and
    cast to `dtype`."""
    c, co = k.shape[3], k.shape[4]
    return filter_transform_lh(k).reshape(36, c, 3, co).permute(0, 2, 3, 1).to(dtype)


def fused_plan(c: int, co: int) -> dict:
    """The fused bf16 kernel's tile for C input and Co output channels:
    rows and BN of a block, the K step BK (64 channels where the padded C
    is a multiple of 64, else 32) and its count nk, the N tiles, the ring
    stages, the shared memory a block takes (1024-byte alignment, ring,
    parked y sets, each N tile's live counts and K slices, static) and the
    f32 accumulator registers of a consumer thread (a set is an m64 x BN
    fragment, BN/2 registers). `csrc/wino4.cu` checks the same shared
    memory at launch."""
    cv = -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN
    n_tiles = -(-co // FUSED_BN)
    bk = 64 if cv % 64 == 0 else 32
    nk = -(-cv // bk)
    stage = -(-FUSED_AROWS * bk * 2 // 1024) * 1024 + 3 * FUSED_BN * bk * 2
    stages = min(FUSED_MAX_STAGES, FUSED_RING_BYTES // stage)
    parked = 2 * FUSED_PARKED_SETS * FUSED_BN // 2 * 128 * 4   # two warpgroups' sets, f32
    return dict(rows=FUSED_ROWS, bn=FUSED_BN, bk=bk, nk=nk, n_tiles=n_tiles, stages=stages,
                register_sets=FUSED_SETS, registers=FUSED_SETS * FUSED_BN // 2,
                parked_bytes=parked,
                smem_bytes=(1024 + stages * stage + parked + 36 * n_tiles * (4 + nk)
                            + FUSED_STATIC_SMEM))


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


def _conv3d_wino4_fused(x: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """bf16 'full' on the card: the input transform and the fused kernel
    (and the live-step pre-pass). Scratch: V (36, M, Cv) bf16 and the live
    table; no Z."""
    b, l, h, w, c = x.shape
    co = k.shape[4]
    plan = fused_plan(c, co)
    ut = kernel_operand(gemm_weights(k, x.dtype), 2, 3)       # (36, 3, Cop, Cv)
    cop, cv = ut.shape[2], ut.shape[3]
    m = b * -(-l // _M) * -(-h // _M) * (w + 2)
    v = torch.empty((36, m, cv), dtype=x.dtype, device=x.device)
    out = torch.empty((b, l, h, w, co), dtype=out_dtype, device=x.device)
    live, live_bytes, _, _ = gemm_args(x, 36, 3, cv, cop, tiles=(plan["bn"], plan["bk"]))
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d_wino4_bf16(
            x.data_ptr(), ut.data_ptr(), v.data_ptr(), out.data_ptr(), live.data_ptr(),
            live_bytes, b, l, h, w, c, cv, co, cop, plan["bk"], plan["stages"],
            DTYPES[out_dtype], _cuda.stream_of(x))
    _cuda.check(err, "conv3d_wino4")
    return out


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
    On the card, bf16 inputs with ablate='full' run the fused kernel
    (input transform, then the 36 products and the collapses in one
    kernel, Z kept on chip, the W taps summed first); f32 inputs and
    'nodot' run the three-launch route through V and Z in device memory,
    so the probe's 'nodot' times that route. The fused kernel skips every
    step whose U blocks of all three W taps are all +-0, so an inf or NaN
    input that only such a step meets gives a finite output where the twin
    gives NaN (`csrc/conv_igemm.cuh`).
    """
    _check(x, k, lt, th, ablate)
    if x.device.type == "cpu":
        return _conv3d_wino4_torch(x, k, out_dtype, lt, th, ablate)
    check_inputs("conv3d_wino4", x, k, out_dtype)
    b, l, h, w, c = x.shape
    co = k.shape[4]
    nl, nh = -(-l // _M), -(-h // _M)
    m = b * nl * nh * (w + 2)            # rows of each of the 36 products
    if m >= 1 << 31 or b * l * h * w >= 1 << 31:
        raise ValueError(f"conv3d_wino4: {tuple(x.shape)} exceeds the kernel's limits")
    xc = x.contiguous()
    if x.dtype == torch.bfloat16 and ablate == "full":
        out = _conv3d_wino4_fused(xc, k, out_dtype)
    else:
        out = _conv3d_wino4_three_launches(xc, k, out_dtype, ablate)
    launches["conv3d_wino4"] += 1
    return out


def _conv3d_wino4_three_launches(x: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype,
                                 ablate: str) -> torch.Tensor:
    """f32 'full' and 'nodot' on the card: the input transform, the 36
    products (or 'nodot''s lane copy) and the output transform, with V and
    Z through device memory."""
    b, l, h, w, c = x.shape
    co = k.shape[4]
    m = b * -(-l // _M) * -(-h // _M) * (w + 2)
    cv = -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN
    n = 3 * co
    npad = -(-n // CHANNEL_ALIGN) * CHANNEL_ALIGN
    if ablate == "full":
        # U as (36, N, C) in f32: every GEMM row contiguous, zero padded
        ut = filter_transform_lh(k).permute(0, 1, 3, 2).reshape(36, n, c)
        ut = F.pad(ut, (0, cv - c, 0, npad - n)).contiguous()
        lanes = None
    else:
        ut = None
        lanes = torch.tensor(nodot_lanes(c, co), dtype=torch.int32, device=x.device)
    v = torch.empty((36, m, cv), dtype=x.dtype, device=x.device)
    z = torch.empty((36, m, npad), dtype=torch.float32, device=x.device)
    out = torch.empty((b, l, h, w, co), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d_wino4(
            x.data_ptr(), ut.data_ptr() if ut is not None else None, v.data_ptr(),
            z.data_ptr(), lanes.data_ptr() if lanes is not None else None, out.data_ptr(),
            b, l, h, w, c, cv, co, npad, ABLATE[ablate], DTYPES[x.dtype], DTYPES[out_dtype],
            _cuda.stream_of(x))
    _cuda.check(err, "conv3d_wino4")
    return out
