"""Frame preprocessing: host-side resize, device-side pair normalization."""

from __future__ import annotations

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.config import FRAME_MEAN, FRAME_STD


def resize_frames(frames: np.ndarray, height: int = 260) -> np.ndarray:
    """uint8 (N, H, W) grayscale frames -> float32 (N, height, W') in [0,1].

    Width is scaled to preserve aspect ratio, truncating like the reference
    (`int(w/h*height)`). Uses cv2 bilinear (the reference's default
    interpolation).
    """
    import cv2  # local: host-only dependency

    frames = frames.astype(np.float32) / 255.0
    h, w = frames.shape[-2:]
    out_w = int(w / h * height)
    if (h, w) == (height, out_w):
        return frames
    return np.stack(
        [cv2.resize(f, (out_w, height)) for f in frames], axis=0
    )


def normalize_pairs(frames: torch.Tensor) -> torch.Tensor:
    """(B, L+1, H, W) float frames -> (B, L, H, W, 2) normalized pair units;
    channel 0 is frame_t, channel 1 is frame_{t+1}."""
    pairs = torch.stack([frames[:, :-1], frames[:, 1:]], dim=-1)
    dev = frames.device
    mean = torch.tensor(np.float32(FRAME_MEAN), device=dev)
    std = torch.tensor(np.float32(FRAME_STD), device=dev)
    return (pairs - mean) / std
