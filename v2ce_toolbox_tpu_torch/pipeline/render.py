"""Event-frame rendering: channel-major voxels -> displayable uint8 frames.

Sum the voxel grid over time bins, map polarities to R/G (blue zero) or
replicate the polarity sum to gray, bound values by min(percentile of the
nonzero values, ceil), clip-normalize and scale to uint8. The reductions
and the bound run on the voxels' device; only the content channels come
to the host.
"""

from __future__ import annotations

import numpy as np
import torch

# inputs up to this many (virtual 3-channel) values take the exact
# interpolated percentile; beyond it a count-threshold bisection
_EXACT_MAX = 1 << 21


def render_event_frames_cmajor(voxels: torch.Tensor, *, ceil: float = 10.0,
                               upper_bound_percentile: int = 98,
                               keep_polarity: bool = True) -> np.ndarray:
    """Channel-major (T, 20, H, W) voxels -> (T, H, W, 3) uint8 frames."""
    t, c, h, w = voxels.shape
    return render_event_frames_from_sums(
        voxels.reshape(t, 2, c // 2, h, w).sum(dim=2), ceil=ceil,
        upper_bound_percentile=upper_bound_percentile, keep_polarity=keep_polarity)


def render_event_frames_from_sums(ef2: torch.Tensor, *, ceil: float = 10.0,
                                  upper_bound_percentile: int = 98,
                                  keep_polarity: bool = True) -> np.ndarray:
    """Per-polarity event-frame sums (T, 2, H, W) -> (T, H, W, 3) uint8
    frames: the streaming driver's path, which keeps only these sums."""
    out = _finish_render(ef2, ceil=float(ceil),
                         upper_bound_percentile=upper_bound_percentile,
                         keep_polarity=keep_polarity)
    return _assemble_channels(out.cpu().numpy(), keep_polarity)


def _assemble_channels(out: np.ndarray, keep_polarity: bool) -> np.ndarray:
    """(T, 2|1, H, W) content channels -> (T, H, W, 3) frames."""
    t, _, h, w = out.shape
    if keep_polarity:
        out = np.concatenate([out, np.zeros((t, 1, h, w), np.uint8)], axis=1)
    else:
        out = np.repeat(out, 3, axis=1)
    return np.moveaxis(out, 1, -1)


def _percentile_bound(flat: torch.Tensor, upper_bound_percentile: int,
                      ceil: float, *, select_len: int, dup: int = 1) -> torch.Tensor:
    """min(percentile of the nonzero values, ceil), at least 1e-6.

    select_len is the length of the legacy 3-channel frame array, which
    picks the branch; gray values are duplicated 3x (`dup`) on the exact
    branch so the interpolation runs over the same multiset."""
    if select_len <= _EXACT_MAX:
        if dup > 1:
            flat = flat.repeat_interleave(dup)
        nz = torch.where(flat > 0, flat, torch.nan)
        bound = torch.nanquantile(nz, upper_bound_percentile / 100.0)
        bound = torch.nan_to_num(bound, nan=1.0)
    else:
        n = (flat > 0).sum()
        k = n.float() * (1.0 - upper_bound_percentile / 100.0)
        lo = torch.zeros((), dtype=torch.float32, device=flat.device)
        hi = flat.max().float()
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            pred = (flat > mid).sum().float() > k
            lo = torch.where(pred, mid, lo)
            hi = torch.where(pred, hi, mid)
        bound = torch.where(n == 0, torch.ones_like(hi), hi)
    return torch.clamp(torch.clamp(bound, max=float(ceil)), min=1e-6)


def _finish_render(ef2: torch.Tensor, *, ceil: float, upper_bound_percentile: int,
                   keep_polarity: bool) -> torch.Tensor:
    """(T, 2, H, W) per-polarity sums -> uint8 content channels: (T, 2, H,
    W) for rgb (R = ON, G = OFF), (T, 1, H, W) for gray."""
    t, _, h, w = ef2.shape
    efs = ef2 if keep_polarity else ef2.sum(dim=1, keepdim=True)
    bound = _percentile_bound(efs.reshape(-1), upper_bound_percentile, ceil,
                              select_len=t * 3 * h * w,
                              dup=1 if keep_polarity else 3)
    efs = torch.minimum(torch.clamp(efs, min=0), bound) / bound
    return (efs * 255.0).to(torch.uint8)
