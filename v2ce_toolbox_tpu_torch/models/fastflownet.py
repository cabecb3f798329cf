"""FastFlowNet: coarse-to-fine optical flow, as torch modules (NCHW).

Counterpart of `v2ce_toolbox_tpu/models/fastflownet.py` (the reference's
train/scripts/utils/fastflownet.py:19-169), whose cost volume is K8
(`ops/correlation.py`): the CUDA kernel on the card, the plain twin on the
CPU. Submodule names are the reference's (`pconv1_1`, ..., `rconv2`,
`up3`, `decoder2.conv1`, ...; each conv + leaky ReLU is a Sequential whose
conv is `.0`), so a reference state_dict loads as it is;
`utils/weights.fastflownet_from_jax_variables` converts the JAX package's
variables.

Structure: a shared 3-level conv pyramid (16/32/64 channels, each /2)
extended by average pools to 1/64; at each of 5 levels, the 53-tap dilated
selection of the 81-tap cost volume between f1 and the flow-warped f2,
concatenated with reduced features and the upsampled coarser flow, decoded
by grouped convs with channel shuffle. K8 writes the 53 taps straight into
channels 0-52 of the decoder's input, allocated once a level, and the
reduced features and the flow are copied into the rest: the reference's
gather and concatenation, without the cost volume's two extra copies.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from v2ce_toolbox_tpu_torch.ops.correlation import correlation

# 53 of the 81 correlation channels, dilated pattern
# (reference: fastflownet.py:72-80)
CORR_INDEX = np.array([
    0, 2, 4, 6, 8,
    10, 12, 14, 16,
    18, 20, 21, 22, 23, 24, 26,
    28, 29, 30, 31, 32, 33, 34,
    36, 38, 39, 40, 41, 42, 44,
    46, 47, 48, 49, 50, 51, 52,
    54, 56, 57, 58, 59, 60, 62,
    64, 66, 68, 70,
    72, 74, 76, 78, 80])

CORR_TAPS = tuple(CORR_INDEX.tolist())
N_TAPS = len(CORR_INDEX)
DECODER_IN = N_TAPS + 32 + 2         # taps, reduced features, upsampled flow

LEVELS = (2, 3, 4, 5, 6)
# the coarser flow is upsampled and scaled to warp f2 at each finer level
WARP_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}


def _convrelu(cin: int, cout: int, stride: int = 1, groups: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, groups=groups),
                         nn.LeakyReLU(0.1))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(N, C, H, W) channel shuffle (reference: fastflownet.py:33-39)."""
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


def bilinear_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp (N, C, H, W) by (N, 2, H, W) pixel-space flow (x, y) with
    bilinear sampling, zeros out of bounds: the JAX package's floor / clip /
    four-corner gather with per-corner validity (not `F.grid_sample`, whose
    coordinate normalisation rounds differently)."""
    n, c, h, w = x.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    sx = xx + flow[:, 0]
    sy = yy + flow[:, 1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat = x.reshape(n, c, h * w)

    def gather(xi, yi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()).view(n, 1, h * w)
        vals = flat.gather(2, idx.expand(n, c, h * w)).view(n, c, h, w)
        return vals * ok[:, None]

    return (gather(x0, y0) * ((1 - wx) * (1 - wy))[:, None]
            + gather(x0 + 1, y0) * (wx * (1 - wy))[:, None]
            + gather(x0, y0 + 1) * ((1 - wx) * wy)[:, None]
            + gather(x0 + 1, y0 + 1) * (wx * wy)[:, None])


class FlowDecoder(nn.Module):
    """87 channels -> 2-channel flow (reference: fastflownet.py:19-52)."""

    def __init__(self, cin: int = 87, groups: int = 3):
        super().__init__()
        self.groups = groups
        self.conv1 = _convrelu(cin, 96)
        self.conv2 = _convrelu(96, 96, groups=groups)
        self.conv3 = _convrelu(96, 96, groups=groups)
        self.conv4 = _convrelu(96, 96, groups=groups)
        self.conv5 = _convrelu(96, 64)
        self.conv6 = _convrelu(64, 32)
        self.conv7 = nn.Conv2d(32, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        x = self.conv1(x)
        x = channel_shuffle(self.conv2(x), g)
        x = channel_shuffle(self.conv3(x), g)
        x = channel_shuffle(self.conv4(x), g)
        return self.conv7(self.conv6(self.conv5(x)))


class FastFlowNet(nn.Module):
    def __init__(self, groups: int = 3):
        super().__init__()
        self.pconv1_1 = _convrelu(3, 16, 2)
        self.pconv1_2 = _convrelu(16, 16)
        self.pconv2_1 = _convrelu(16, 32, 2)
        self.pconv2_2 = _convrelu(32, 32)
        self.pconv2_3 = _convrelu(32, 32)
        self.pconv3_1 = _convrelu(32, 64, 2)
        self.pconv3_2 = _convrelu(64, 64)
        self.pconv3_3 = _convrelu(64, 64)
        self.rconv2 = _convrelu(32, 32)
        for lvl in (3, 4, 5, 6):
            setattr(self, f"rconv{lvl}", _convrelu(64, 32))
        for lvl in (3, 4, 5, 6):
            setattr(self, f"up{lvl}", nn.ConvTranspose2d(2, 2, 4, 2, 1))
        for lvl in LEVELS:
            setattr(self, f"decoder{lvl}", FlowDecoder(DECODER_IN, groups))

    def pyramid(self, img: torch.Tensor):
        f1 = self.pconv1_2(self.pconv1_1(img))
        f2 = self.pconv2_3(self.pconv2_2(self.pconv2_1(f1)))
        f3 = self.pconv3_3(self.pconv3_2(self.pconv3_1(f2)))
        f4 = F.avg_pool2d(f3, 2)
        f5 = F.avg_pool2d(f4, 2)
        f6 = F.avg_pool2d(f5, 2)
        return {2: f2, 3: f3, 4: f4, 5: f5, 6: f6}

    def cost_volume(self, f1: torch.Tensor, f2: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The CORR_INDEX taps of the 81-tap cost volume, (N, 53, H, W);
        written into `out` where given (a view whose batch stride may
        exceed 53*H*W)."""
        return correlation(f1, f2, max_displacement=4, taps=CORR_TAPS, out=out)

    def decoder_input(self, lvl: int, f1: torch.Tensor, f2: torch.Tensor,
                      flow_up: Optional[torch.Tensor]) -> torch.Tensor:
        """(N, 87, H, W): the cost volume, rconv<lvl>(f1) and flow_up
        (zeros where None), in that channel order."""
        n, _, h, w = f1.shape
        x = f1.new_empty((n, DECODER_IN, h, w))
        self.cost_volume(f1, f2, out=x[:, :N_TAPS])
        x[:, N_TAPS:N_TAPS + 32] = getattr(self, f"rconv{lvl}")(f1)
        if flow_up is None:
            x[:, N_TAPS + 32:].zero_()
        else:
            x[:, N_TAPS + 32:] = flow_up
        return x

    def forward(self, img_pair: torch.Tensor, train: bool = False):
        """img_pair: (N, 6, H, W) two stacked RGB frames, H, W % 64 == 0.
        Returns the 1/4-resolution flow (N, 2, H/4, W/4); with train=True
        the flows of all 5 levels, finest first."""
        feats1 = self.pyramid(img_pair[:, :3])
        feats2 = self.pyramid(img_pair[:, 3:6])
        flows = {6: self.decoder6(self.decoder_input(6, feats1[6], feats2[6], None))}
        for lvl in (5, 4, 3, 2):
            flow_up = getattr(self, f"up{lvl + 1}")(flows[lvl + 1])
            f2w = bilinear_warp(feats2[lvl], flow_up * WARP_SCALE[lvl])
            x = self.decoder_input(lvl, feats1[lvl], f2w, flow_up)
            flows[lvl] = getattr(self, f"decoder{lvl}")(x) + flow_up
        if train:
            return tuple(flows[i] for i in LEVELS)
        return flows[2]


def init_fastflownet(model: FastFlowNet, seed: int = 0) -> None:
    """Seeded random init: normal kernels with std 1/sqrt(fan_in) (flax's
    default lecun-normal scale, untruncated), zero biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                # Conv2d (out, in/g, kh, kw); ConvTranspose2d (in, out, kh, kw)
                fan_in = (w.shape[1] if isinstance(m, nn.Conv2d) else w.shape[0]) \
                    * math.prod(w.shape[2:])
                w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
                m.bias.zero_()


class OpticalFlowCalculator:
    """Size-padding wrapper (reference: train/scripts/utils/optical_flow.py:
    20-116): pads H and W to multiples of div_size, runs the net, scales by
    div_flow and resizes the flow back to the input resolution."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 div_flow: float = 20.0, div_size: int = 64, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        self.net = FastFlowNet()
        if state_dict is None:
            init_fastflownet(self.net, seed)
        else:
            self.net.load_state_dict(state_dict)
        self.net.to(self.device).eval()
        self.div_flow = div_flow
        self.div_size = div_size

    @torch.no_grad()
    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) pairs -> (N, 2, H, W) flow, on the calculator's
        device."""
        img1, img2 = img1.to(self.device), img2.to(self.device)
        n, _, h, w = img1.shape
        ph = -h % self.div_size
        pw = -w % self.div_size
        x = F.pad(torch.cat([img1, img2], 1), (0, pw, 0, ph))
        flow = self.div_flow * self.net(x)                 # 1/4 resolution
        # bilinear resize back to full resolution, vectors scaled by 4
        # (jax.image.resize's bilinear upsample is align_corners=False)
        flow = F.interpolate(flow, size=(h + ph, w + pw), mode="bilinear",
                             align_corners=False) * 4.0
        return flow[:, :, :h, :w]
