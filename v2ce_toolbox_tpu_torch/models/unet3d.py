"""3D UNet for event-voxel prediction (concat skips), NCDHW.

  head:      ConvLayer3D(in -> base, k3 s1 p1, LeakyReLU)
  encoders:  ResidualBlock3D stride (1,2,2), channels x2 each, BN, no SN
  resblocks: ResidualBlock3D at the widest width, BN, SN
  decoders:  nearest upsample to the skip's (H, W), concat [x, skip],
             ResidualBlock3D -> half the channels, BN, SN
  pred:      ConvLayer3D(base -> out, k1, final activation)

The frame axis L is the conv depth axis D.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import (
    ConvLayer3D,
    ResidualBlock3D,
    upsample_nearest_to,
)


class UNet3D(nn.Module):
    def __init__(self, num_input_channels: int = 2, num_output_channels: int = 20,
                 skip_type: str = "concat", activation: str = "relu",
                 num_encoders: int = 4, base_num_channels: int = 32,
                 num_residual_blocks: int = 2, norm: Optional[str] = "BN",
                 sn: bool = True):
        super().__init__()
        if skip_type != "concat":
            raise NotImplementedError("only concat skips are ported")
        base = base_num_channels
        max_ch = base * 2 ** num_encoders
        self.head = ConvLayer3D(num_input_channels, base, 3, 1, 1,
                                activation="LeakyReLU")
        self.encoders = nn.ModuleList(
            ResidualBlock3D(base * 2 ** i, base * 2 ** (i + 1), (1, 2, 2), norm, False)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(
            ResidualBlock3D(max_ch, max_ch, (1, 1, 1), norm, sn)
            for _ in range(num_residual_blocks))
        # decoder i takes concat(upsampled, skip): in = out*2 + out = 1.5x
        self.decoders = nn.ModuleList(
            ResidualBlock3D(max_ch // 2 ** i + max_ch // 2 ** (i + 1),
                            max_ch // 2 ** (i + 1), (1, 1, 1), norm, sn)
            for i in range(num_encoders))
        self.pred = ConvLayer3D(base, num_output_channels, 1, 1, 0,
                                activation=activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        skips = []
        for enc in self.encoders:
            skips.append(x)
            x = enc(x)
        for res in self.resblocks:
            x = res(x)
        for dec, skip in zip(self.decoders, reversed(skips)):
            x = upsample_nearest_to(x, skip.shape[-2:])
            x = dec(torch.cat([x, skip], dim=1))
        return self.pred(x)
