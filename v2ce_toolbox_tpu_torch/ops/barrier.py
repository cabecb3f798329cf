"""K7: `layout_barrier`, the identity kernel the JAX package's probe
`window_lb` launches between the stage-1 model and the sampler.

Counterpart of `v2ce_toolbox_tpu/ops/barrier.py:layout_barrier`. On the
TPU the identity is a Pallas custom call, which pins XLA's default layouts
on both sides and so stops the sampler's channel-major preference from
propagating back into the model's conv layouts. PyTorch runs eagerly and
has no layout to firewall, so in the port it is only what it computes: a
copy of x, one block per (h, w) plane of x viewed as (lead, h, w)
(`csrc/stream_copy.cu`). On a CPU tensor it runs its plain twin
(`clone()`); on a CUDA tensor it launches the kernel, or raises.
"""

from __future__ import annotations

import torch

from v2ce_toolbox_tpu_torch.ops import _cuda

launches = {"layout_barrier": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _layout_barrier_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of `layout_barrier` (any device)."""
    return x.clone()


def layout_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity (K7): a copy of x with x's shape, dtype and device."""
    if x.device.type == "cpu":
        return _layout_barrier_torch(x)
    if x.device.type != "cuda":
        raise ValueError(f"layout_barrier: expected a CUDA tensor, got {x.device}")
    shape = (1, x.numel()) if x.dim() < 2 else x.shape
    xc = x.contiguous()
    out = torch.empty_like(xc)
    lead = xc.numel() // (shape[-2] * shape[-1]) if xc.numel() else 0
    with torch.cuda.device(x.device):
        err = _cuda.lib().v2ce_layout_barrier(xc.data_ptr(), out.data_ptr(), lead,
                                              shape[-2] * shape[-1] * xc.element_size(),
                                              _cuda.stream_of(x))
    _cuda.check(err, "layout_barrier")
    launches["layout_barrier"] += 1
    return out
