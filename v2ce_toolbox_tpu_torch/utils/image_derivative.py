"""Sobel image gradients and the double-blurred pair gradient channel, on
channels-last (B, H, W, C) tensors, where the tensors are.

The port of `v2ce_toolbox_tpu/utils/image_derivative.py`: its dense convs
with eye-weighted kernels are depthwise convs here (`groups=C`, the same
nonzero products), and the gaussian blur is separable with reflect
padding, H first and then W, as there (torchvision's gaussian_blur with
kernel 11, sigma 3).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def _depthwise(x: torch.Tensor, k: np.ndarray, padding) -> torch.Tensor:
    """NCHW x correlated with the 2-D kernel k on every channel."""
    c = x.shape[1]
    w = torch.as_tensor(k, device=x.device).expand(c, 1, *k.shape)
    return F.conv2d(x, w, padding=padding, groups=c)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def batch_img_gradient(img: torch.Tensor) -> torch.Tensor:
    """Sobel magnitude per channel, zero-padded; (B, H, W, C) -> (B, H,
    W, C)."""
    x = _nchw(img)
    gx = _depthwise(x, _SOBEL_X, 1)
    gy = _depthwise(x, np.ascontiguousarray(_SOBEL_X.T), 1)
    return _nhwc(torch.sqrt(gx * gx + gy * gy))


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, kernel_size: int = 11, sigma: float = 3.0) -> torch.Tensor:
    """Separable gaussian blur of (B, H, W, C), reflect-padded."""
    k1 = _gaussian_kernel1d(kernel_size, sigma)
    pad = kernel_size // 2
    x = F.pad(_nchw(img), (0, 0, pad, pad), mode="reflect")
    x = _depthwise(x, k1[:, None], 0)
    x = F.pad(x, (pad, pad, 0, 0), mode="reflect")
    return _nhwc(_depthwise(x, k1[None, :], 0))


def get_batch_double_blurred_image_gradient(image1: torch.Tensor, image2: torch.Tensor,
                                            sigma: float = 3.0,
                                            kernel_size: int = 11) -> torch.Tensor:
    """max(|grad img1|, |grad img2|), blurred: the optional model input
    channel."""
    g = torch.maximum(batch_img_gradient(image1), batch_img_gradient(image2))
    return gaussian_blur(g, kernel_size, sigma)


def batch_img_residual(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return img2 - img1
