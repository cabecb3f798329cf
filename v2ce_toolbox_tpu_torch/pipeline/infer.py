"""Stage-1 forward step with the center crop or panoramic width tiling.

Center mode crops the middle `width` columns. Pano mode tiles the width
into ceil(W'/width) strips, the last one right-aligned, folds the strips
into the batch axis of one forward pass, trims the last strip's output to
the remainder and concatenates on width (`v2ce_toolbox_tpu/pipeline/
infer.py:57-81`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from v2ce_toolbox_tpu_torch.pipeline.preprocess import normalize_pairs


def center_crop(units: torch.Tensor, width: int) -> torch.Tensor:
    """Center-crop the width axis of (B, L, H, W, C) units."""
    w = units.shape[3]
    lo = w // 2 - width // 2
    return units[:, :, :, lo:lo + width]


def make_forward_fn(model: torch.nn.Module, *, infer_type: str = "center",
                    width: int = 346, resized_width: Optional[int] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, L+1, H, W') frames -> (B, L, H, W_out, 20) voxels: pair
    normalization, the center crop (W_out = width) or the pano strips
    (W_out = W', which `resized_width` must give), and the model in eval
    mode, without autograd."""
    if infer_type not in ("center", "pano"):
        raise ValueError(f"invalid infer_type {infer_type!r}")
    if infer_type == "pano":
        if resized_width is None:
            raise ValueError("pano mode needs resized_width")
        n_strips = -(-resized_width // width)
        remainder = resized_width % width

    @torch.inference_mode()
    def fwd(frames: torch.Tensor) -> torch.Tensor:
        units = normalize_pairs(frames.float())
        if infer_type == "center":
            return model(center_crop(units, width))
        b = units.shape[0]
        strips = [units[:, :, :, i * width:(i + 1) * width] for i in range(n_strips - 1)]
        strips.append(units[:, :, :, -width:])        # right-aligned last strip
        outs = list(torch.split(model(torch.cat(strips, dim=0)), b, dim=0))
        if remainder != 0:
            outs[-1] = outs[-1][:, :, :, -remainder:]
        return torch.cat(outs, dim=3)                 # (B, L, H, W', 20)

    return fwd
