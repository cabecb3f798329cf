"""K9: the 3x3x3 stride-1 'same' convolution of the stage-1 model's
research configuration (conv_impl='pallas').

Counterpart of `v2ce_toolbox_tpu/ops/conv3d_pallas.py:conv3d_3x3x3`, with
its layout: x (B, L, H, W, C) and k (3, 3, 3, C, Co), f32 or bf16 (the
same for both), f32 accumulation, output in `out_dtype`. On a CPU tensor
it runs the plain twin (f32 upcast, `F.conv3d`, cast); on a CUDA tensor it
launches `csrc/conv3d.cu`, or raises. The GEMM core's tile choice
(`gemm_tiles`), its live-step table (`gemm_args`) and the plain twin of its
pre-pass (`live_steps`) live here for all four conv entries.

The model hands in channels-last views: an NCDHW tensor in
`torch.channels_last_3d` memory format permuted to NDHWC is contiguous, so
the kernel reads it without a copy, and its NDHWC output permuted back is
again a channels-last NCDHW tensor.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda

launches = {"conv3d_3x3x3": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_ALIGN = 8        # the kernels read channels in 16-byte vectors


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _conv3d_3x3x3_torch(x: torch.Tensor, k: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of `conv3d_3x3x3` (any device): the products of the
    (possibly bf16) inputs are exact in f32, summed in f32."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), k.float().permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1).to(out_dtype)


def check_inputs(name: str, x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    """What the conv kernels take: CUDA tensors of one dtype, f32 or bf16,
    and an f32 or bf16 output."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: expected CUDA tensors, got {x.device} and {w.device}")
    if x.dtype not in DTYPES or w.dtype != x.dtype or out_dtype not in DTYPES:
        raise ValueError(f"{name}: inputs must share a dtype, float32 or bfloat16, and the "
                         f"output be one of them; got {x.dtype}, {w.dtype} -> {out_dtype}")


def kernel_operand(t: torch.Tensor, *dims: int) -> torch.Tensor:
    """t zero-padded along each of `dims` (non-negative) to a multiple of
    CHANNEL_ALIGN, contiguous and 16-byte aligned."""
    for d in dims:
        extra = -t.shape[d] % CHANNEL_ALIGN
        if extra:
            t = F.pad(t, [0, 0] * (t.dim() - 1 - d) + [0, extra])
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def gemm_tiles(c: int, co: int) -> tuple:
    """(BN, BK) of the bf16 GEMM core (`csrc/conv_igemm.cuh`) for C input
    and Co output channels, both padded to CHANNEL_ALIGN: the N tile is 32
    for Co <= 32 (no idle half of a wider tile), 64 for Co <= 64, else 128;
    the K step is 64 channels (one 128-byte swizzled row) where C is a
    multiple of 64, else 32."""
    bn = 32 if co <= 32 else 64 if co <= 64 else 128
    bk = 64 if c % 64 == 0 else 32
    return bn, bk


def live_steps(kt: torch.Tensor, bn: int, bk: int) -> torch.Tensor:
    """Plain twin of the GEMM core's live-step pre-pass: for weights kt
    (planes, taps, Co, C) and the tile (bn, bk), a bool table (planes,
    ceil(Co/bn), taps, ceil(C/bk)), True where the step's bn x bk weight
    block holds a value other than +-0 (a NaN counts). The kernel runs only
    the True steps."""
    p, t, co, c = kt.shape
    nt, nk = -(-co // bn), -(-c // bk)
    nz = F.pad(kt, (0, nk * bk - c, 0, nt * bn - co)) != 0
    return nz.reshape(p, t, nt, bn, nk, bk).any(5).any(3).permute(0, 2, 1, 3)


_live_tables = None      # the list `record_live` fills, while it is open


@contextlib.contextmanager
def record_live():
    """Keep the live-step table of every bf16 conv call made inside the
    block: yields a list that gets, per call, the uint8 table (planes,
    ceil(Co/BN), taps, ceil(C/BK)) as the kernel's pre-pass fills it on the
    call's stream (1 = live). Its plain twin is `live_steps`."""
    global _live_tables
    _live_tables = []
    try:
        yield _live_tables
    finally:
        _live_tables = None


def gemm_args(x: torch.Tensor, planes: int, taps: int, c: int, co: int, tiles=None) -> tuple:
    """The bf16 core's extra arguments for a call: (live-step table, its
    bytes, BN, BK), the table allocated here for the kernel's pre-pass to
    fill; f32 inputs take none (None, 0, 0, 0). `tiles` overrides
    `gemm_tiles`."""
    if x.dtype != torch.bfloat16:
        return None, 0, 0, 0
    bn, bk = tiles or gemm_tiles(c, co)
    nt, nk = -(-co // bn), -(-c // bk)
    live = torch.empty(planes * nt * taps * nk, dtype=torch.uint8, device=x.device)
    if _live_tables is not None:
        _live_tables.append(live.view(planes, nt, taps, nk))
    return live, live.numel(), bn, bk


def conv3d_3x3x3(x: torch.Tensor, k: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3x3 stride-1 'same' conv, channels-last (K9).

    Args:
      x: (B, L, H, W, C) activations, float32 or bfloat16.
      k: (3, 3, 3, C, Co) filter of x's dtype.
      out_dtype: float32 or bfloat16.
    Returns:
      (B, L, H, W, Co) in out_dtype, summed in f32.
    With bf16 inputs on the card the kernel skips every weight block that
    is all +-0, so an inf or NaN input that only such a block meets gives a
    finite output where the twin gives NaN (`csrc/conv_igemm.cuh`).
    """
    if x.device.type == "cpu":
        return _conv3d_3x3x3_torch(x, k, out_dtype)
    check_inputs("conv3d_3x3x3", x, k, out_dtype)
    if x.dim() != 5 or k.shape[:3] != (3, 3, 3) or k.dim() != 5 or k.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_3x3x3: expected x (B, L, H, W, C) and k (3, 3, 3, C, Co), "
                         f"got {tuple(x.shape)} and {tuple(k.shape)}")
    b, l, h, w, _ = x.shape
    co = k.shape[4]
    # weights as (tap, Co, C): every GEMM row of the kernel is contiguous
    kt = kernel_operand(k.permute(0, 1, 2, 4, 3).reshape(27, co, -1), 1, 2)
    xc = kernel_operand(x, 4)
    cp, cop = xc.shape[4], kt.shape[1]
    out = torch.empty((b, l, h, w, cop), dtype=out_dtype, device=x.device)
    live, live_bytes, bn, bk = gemm_args(x, 1, 27, cp, cop)
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d(xc.data_ptr(), kt.data_ptr(), out.data_ptr(),
                                      live if live is None else live.data_ptr(), live_bytes,
                                      b, l, h, w, cp, cop, bn, bk, DTYPES[x.dtype],
                                      DTYPES[out_dtype], _cuda.stream_of(x))
    _cuda.check(err, "conv3d_3x3x3")
    launches["conv3d_3x3x3"] += 1
    return out if cop == co else out[..., :co]
