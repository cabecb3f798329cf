"""Stage-1 forward step with the center crop."""

from __future__ import annotations

from typing import Callable

import torch

from v2ce_toolbox_tpu_torch.pipeline.preprocess import normalize_pairs


def center_crop(units: torch.Tensor, width: int) -> torch.Tensor:
    """Center-crop the width axis of (B, L, H, W, C) units."""
    w = units.shape[3]
    lo = w // 2 - width // 2
    return units[:, :, :, lo:lo + width]


def make_forward_fn(model: torch.nn.Module, *, infer_type: str = "center",
                    width: int = 346) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, L+1, H, W') frames -> (B, L, H, width, 20) voxels: pair
    normalization, center crop and the model in eval mode, without
    autograd."""
    if infer_type == "pano":
        raise NotImplementedError(
            "pano inference is not ported yet (ROADMAP item 9)")
    if infer_type != "center":
        raise ValueError(f"invalid infer_type {infer_type!r}")

    @torch.inference_mode()
    def fwd(frames: torch.Tensor) -> torch.Tensor:
        units = center_crop(normalize_pairs(frames.float()), width)
        return model(units)

    return fwd
