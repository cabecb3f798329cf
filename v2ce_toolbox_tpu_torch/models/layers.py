"""Building blocks of the V2ce3d stage-1 model, as torch modules (NCDHW).

Submodule and parameter names follow the reference torch state_dict (the
keys `v2ce_toolbox_tpu/utils/torch_compat.py` converts), so a released
`v2ce_3d.pt` loads as it is:

  ConvLayer3D:      conv3d.{weight,bias}
  ResidualBlock3D:  conv1, bn1, conv2, bn2, downsample.0 (1x1x1 conv),
                    downsample.1 (BN); with spectral norm conv1/conv2 are
                    SNConv3d: module.{weight_bar,weight_u,weight_v}
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class _SNParams(nn.Module):
    """Holder of a spectrally normalised conv's tensors (the reference's
    wrapped module): weight_bar, the power-iteration vectors weight_u /
    weight_v, and the bias if any."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(cout, cin, k, k, k))
        self.weight_u = nn.Parameter(torch.empty(cout), requires_grad=False)
        self.weight_v = nn.Parameter(torch.empty(cin * k ** 3), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class SNConv3d(nn.Module):
    """Conv3d with the reference's spectral norm: one power iteration from
    the stored (u, v) on every forward, sigma from the updated vectors, the
    kernel divided by sigma. u and v are written back only in training
    mode; in eval nothing mutates."""

    def __init__(self, cin: int, cout: int, k: int, stride=1, padding=0,
                 bias: bool = True):
        super().__init__()
        self.module = _SNParams(cin, cout, k, bias)
        self.stride = stride
        self.padding = padding

    def weight(self) -> torch.Tensor:
        m = self.module
        w2d = m.weight_bar.reshape(m.weight_bar.shape[0], -1)
        v = _l2normalize(w2d.t() @ m.weight_u)
        u = _l2normalize(w2d @ v)
        sigma = u @ (w2d @ v)
        if self.training:
            with torch.no_grad():
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        return m.weight_bar / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight(), self.module.bias, self.stride, self.padding)


def _conv(cin: int, cout: int, k: int, stride, padding, bias: bool, sn: bool):
    if sn:
        return SNConv3d(cin, cout, k, stride, padding, bias)
    return nn.Conv3d(cin, cout, k, stride, padding, bias=bias)


def _activation(name: Optional[str]):
    if name is None:
        return None
    if name == "LeakyReLU":
        return nn.LeakyReLU(0.01)
    if name == "relu":
        return nn.ReLU()
    if name == "sigmoid":
        return nn.Sigmoid()
    if name == "tanh":
        return nn.Tanh()
    raise ValueError(f"unknown activation {name!r}")


class ConvLayer3D(nn.Module):
    """conv3d + optional BN (momentum 0.01, eps 1e-5) + optional activation."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride=1,
                 padding: int = 0, activation: Optional[str] = "LeakyReLU",
                 norm: Optional[str] = None, sn: bool = False):
        super().__init__()
        self.conv3d = _conv(cin, cout, kernel_size, stride, padding, norm != "BN", sn)
        self.norm_layer = (nn.BatchNorm3d(cout, eps=1e-5, momentum=0.01)
                           if norm == "BN" else None)
        self.activation = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3d(x)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        if self.activation is not None:
            out = self.activation(out)
        return out


class ResidualBlock3D(nn.Module):
    """conv-bn-relu-conv-bn plus a projection shortcut (1x1x1 conv with bias
    and BN) on every block, as the reference builds it."""

    def __init__(self, cin: int, cout: int, stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: Optional[str] = None, sn: bool = False):
        super().__init__()
        bias = norm != "BN"
        self.conv1 = _conv(cin, cout, 3, stride, 1, bias, sn)
        self.conv2 = _conv(cout, cout, 3, 1, 1, bias, sn)
        with_bn = norm in ("BN", "IN")
        self.bn1 = nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1) if with_bn else None
        self.bn2 = nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1) if with_bn else None
        self.downsample = nn.Sequential(
            nn.Conv3d(cin, cout, 1, stride, 0, bias=True),
            nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        if self.bn1 is not None:
            out = self.bn1(out)
        out = F.relu(out)
        out = self.conv2(out)
        if self.bn2 is not None:
            out = self.bn2(out)
        return F.relu(out + self.downsample(x))


def upsample_nearest_to(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of (B, C, L, H, W) to a target (H, W) with the
    index convention src = floor(dst * in / out), in integer arithmetic."""
    th, tw = target_hw
    h, w = x.shape[-2:]
    hi = torch.arange(th, device=x.device) * h // th
    wi = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(3, hi).index_select(4, wi)
