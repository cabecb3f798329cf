"""K8: the correlation cost volume of FastFlowNet.

Counterpart of `v2ce_toolbox_tpu/ops/correlation.py:correlation`, in the
port's NCHW layout: f1, f2 (N, C, H, W) f32 -> (N, (2md+1)^2, H, W) f32,

    out[n, (dy+md)*(2md+1) + (dx+md), y, x]
        = (sum_c f1[n, c, y, x] * f2[n, c, y+dy, x+dx]) * (1/C)

with f2 zero outside its plane: the TPU kernel's `sum * inv_c`. On a CPU
tensor it runs the plain twin; on a CUDA tensor it launches
`csrc/correlation.cu`, or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.ops import _cuda

launches = {"correlation": 0}

MAX_DISPLACEMENTS = (1, 2, 3, 4)     # the kernel's compiled variants


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _correlation_torch(f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 4) -> torch.Tensor:
    """Plain twin of `correlation` (any device)."""
    md = max_displacement
    _, c, h, w = f1.shape
    f2p = F.pad(f2, (md, md, md, md))
    taps = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(1)
            for dy in range(2 * md + 1) for dx in range(2 * md + 1)]
    return torch.stack(taps, 1) * (1.0 / c)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """Cost volume (K8).

    Args:
      f1, f2: (N, C, H, W) float32 feature maps of one device.
      max_displacement: md, 1 to 4 on the card; (2md+1)^2 taps.
    Returns:
      (N, (2md+1)^2, H, W) float32.
    """
    if f1.device.type == "cpu":
        return _correlation_torch(f1, f2, max_displacement)
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation: expected CUDA tensors, got {f1.device} and {f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise ValueError(f"correlation: expected float32, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation: expected two (N, C, H, W) maps of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if max_displacement not in MAX_DISPLACEMENTS:
        raise ValueError(f"correlation: max_displacement must be one of {MAX_DISPLACEMENTS}, "
                         f"got {max_displacement}")
    n, c, h, w = f1.shape
    d = 2 * max_displacement + 1
    a, b = f1.contiguous(), f2.contiguous()
    out = torch.empty((n, d * d, h, w), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        err = _cuda.lib().v2ce_correlation(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                           n, c, h, w, max_displacement, 1.0 / c,
                                           _cuda.stream_of(f1))
    _cuda.check(err, "correlation")
    launches["correlation"] += 1
    return out
