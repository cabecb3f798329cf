"""K9: the 3x3x3 stride-1 'same' convolution of the stage-1 model's
research configuration (conv_impl='pallas').

Counterpart of `v2ce_toolbox_tpu/ops/conv3d_pallas.py:conv3d_3x3x3`, with
its layout: x (B, L, H, W, C) and k (3, 3, 3, C, Co), f32 or bf16 (the
same for both), f32 accumulation, output in `out_dtype`. On a CPU tensor
it runs the plain twin (f32 upcast, `F.conv3d`, cast); on a CUDA tensor it
launches `csrc/conv3d.cu`, or raises.

The model hands in channels-last views: an NCDHW tensor in
`torch.channels_last_3d` memory format permuted to NDHWC is contiguous, so
the kernel reads it without a copy, and its NDHWC output permuted back is
again a channels-last NCDHW tensor.
"""

from __future__ import annotations

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


def conv3d_3x3x3(x: torch.Tensor, k: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3x3 stride-1 'same' conv, channels-last (K9).

    Args:
      x: (B, L, H, W, C) activations, float32 or bfloat16.
      k: (3, 3, 3, C, Co) filter of x's dtype.
      out_dtype: float32 or bfloat16.
    Returns:
      (B, L, H, W, Co) in out_dtype, summed in f32.
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
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_conv3d(xc.data_ptr(), kt.data_ptr(), out.data_ptr(),
                                      b, l, h, w, cp, cop, DTYPES[x.dtype], DTYPES[out_dtype],
                                      _cuda.stream_of(x))
    _cuda.check(err, "conv3d_3x3x3")
    launches["conv3d_3x3x3"] += 1
    return out if cop == co else out[..., :co]
