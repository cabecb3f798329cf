"""K11: the quad convs of the JAX package's probe harness, `conv3d_quad`
(3x3x3 stride-1 'same') and `conv3d_quad_s122` (3x3x3 stride (1,2,2)
'same', through the phase fold `fold_s122`).

Counterpart of `v2ce_toolbox_tpu/ops/conv3d_quad.py`, with its layout: x
(B, L, H, W, C) and k (kl, kh, kw, C, Co), f32 or bf16 (the same for
both), f32 accumulation, output in `out_dtype` (f32 by default). Both
entry points pad or fold in plain torch, as the JAX package does in XLA,
and hand the pre-padded input to `quad_core`, a VALID conv over the tap
box. On a CPU tensor `quad_core` runs its plain twin (`F.conv3d` summed in
f64, then the cast); on a CUDA tensor it launches `csrc/conv3d_quad.cu`,
or raises. The JAX wrappers' `ws` and `tiles` pick the TPU's lane packing and
VMEM tiles and do not change the result: they have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda
from v2ce_toolbox_tpu_torch.ops.conv3d import DTYPES, check_inputs, kernel_operand

launches = {"conv3d_quad": 0}
MAX_TAPS = 27                   # the tap table of csrc/conv_igemm.cuh


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _quad_core_torch(x: torch.Tensor, k: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of `quad_core` (any device): the conv summed in f64, then
    rounded to out_dtype. An f32 sum in one running total (cuDNN's, or the
    CPU's) of the probe's 27 x 768 positive products lands ~1e-5 of the
    largest output from the exact sum, as far as the kernel's f32 step sums
    may be from the twin; in f64 the twin is the exact sum, rounded once."""
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3), k.double().permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1).to(out_dtype)


def quad_core(x: torch.Tensor, k: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """VALID conv of a pre-padded x (B, Lp, Hp, Wp, C) with k (kl, kh, kw, C,
    Co), kl*kh*kw <= 27 (`_quad_core`, `conv3d_quad.py:156`). Returns
    (B, Lp-kl+1, Hp-kh+1, Wp-kw+1, Co) in out_dtype, summed in f32."""
    if x.dim() != 5 or k.dim() != 5 or k.shape[3] != x.shape[4] \
            or any(k.shape[i] > x.shape[i + 1] for i in range(3)):
        raise ValueError(f"quad_core: expected x (B, Lp, Hp, Wp, C) and k (kl, kh, kw, C, Co) "
                         f"with the tap box inside x, got {tuple(x.shape)} and "
                         f"{tuple(k.shape)}")
    if x.device.type == "cpu":
        return _quad_core_torch(x, k, out_dtype)
    check_inputs("quad_core", x, k, out_dtype)
    kl, kh, kw, _, co = k.shape
    if kl * kh * kw > MAX_TAPS:
        raise ValueError(f"quad_core: {kl}x{kh}x{kw} taps exceed the kernel's {MAX_TAPS}")
    b, lp, hp, wp, _ = x.shape
    # weights as (tap, Co, C): every GEMM row of the kernel is contiguous
    kt = kernel_operand(k.permute(0, 1, 2, 4, 3).reshape(kl * kh * kw, co, -1), 1, 2)
    xc = kernel_operand(x, 4)
    cp, cop = xc.shape[4], kt.shape[1]
    out = torch.empty((b, lp - kl + 1, hp - kh + 1, wp - kw + 1, cop), dtype=out_dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d_quad(xc.data_ptr(), kt.data_ptr(), out.data_ptr(),
                                           b, lp, hp, wp, cp, cop, kl, kh, kw,
                                           DTYPES[x.dtype], DTYPES[out_dtype],
                                           _cuda.stream_of(x))
    _cuda.check(err, "conv3d_quad")
    launches["conv3d_quad"] += 1
    return out if cop == co else out[..., :co]


def conv3d_quad(x: torch.Tensor, k: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3x3 stride-1 'same' conv, channels-last (`conv3d_quad.py:239`).

    Args:
      x: (B, L, H, W, C), float32 or bfloat16.
      k: (3, 3, 3, C, Co) of x's dtype.
    Returns:
      (B, L, H, W, Co) in out_dtype, summed in f32.
    """
    if k.shape[:3] != (3, 3, 3):
        raise ValueError(f"conv3d_quad: expected a 3x3x3 filter, got {tuple(k.shape)}")
    return quad_core(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), k, out_dtype)


def conv3d_quad_s122(x: torch.Tensor, k: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3x3 stride-(1,2,2) 'same' conv via the phase fold
    (`conv3d_quad.py:255`): a (3, 2, 2) VALID conv of `fold_s122(x, k)`.

    Args:
      x: (B, L, H, W, C), float32 or bfloat16.
      k: (3, 3, 3, C, Co) of x's dtype.
    Returns:
      (B, L, ceil(H/2), ceil(W/2), Co) in out_dtype, summed in f32.
    """
    xf, k4 = fold_s122(x, k)
    return quad_core(xf, k4, out_dtype)


def fold_s122(x: torch.Tensor, k: torch.Tensor):
    """Space-to-depth phase fold of a 3x3x3 stride-(1,2,2) 'same' conv
    (`conv3d_quad.py:275`): returns (xf (B, L+2, ceil(H/2)+1, ceil(W/2)+1,
    4C), k4 (3, 2, 2, 4C, Co)) such that a stride-1 VALID (3, 2, 2) conv of
    xf with k4 equals the strided conv. Channels fold as (ph_w, ph_h, c);
    tap (du, dv) of phase (ph_h, ph_w) holds k[dl, 2du+ph_h, 2dv+ph_w], zero
    where that index reaches 3."""
    b, l, h, w, c = x.shape
    co = k.shape[-1]
    ho, wo = -(-h // 2), -(-w // 2)
    xp = F.pad(x, (0, 0, 1, 2 * (wo + 1) - w - 1, 1, 2 * (ho + 1) - h - 1, 1, 1))
    xh = torch.cat([xp[:, :, 0::2], xp[:, :, 1::2]], dim=-1)
    xf = torch.cat([xh[:, :, :, 0::2], xh[:, :, :, 1::2]], dim=-1)
    kz = torch.cat([k, k.new_zeros((3, 1, 3, c, co))], dim=1)
    kz = torch.cat([kz, kz.new_zeros((3, 4, 1, c, co))], dim=2)
    parts = [kz[:, [ph_h, 2 + ph_h]][:, :, [ph_w, 2 + ph_w]]
             for ph_w in (0, 1) for ph_h in (0, 1)]
    return xf, torch.cat(parts, dim=3)
