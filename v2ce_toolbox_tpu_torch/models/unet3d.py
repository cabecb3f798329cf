"""3D UNet for event-voxel prediction (concat skips), NCDHW.

  head:      ConvLayer3D(in -> base, k3 s1 p1, LeakyReLU)
  encoders:  ResidualBlock3D stride (1,2,2), channels x2 each, BN, no SN
  resblocks: ResidualBlock3D at the widest width, BN, SN
  decoders:  nearest upsample to the skip's (H, W), concat [x, skip],
             ResidualBlock3D -> half the channels, BN, SN
  pred:      ConvLayer3D(base -> out, k1, final activation)

The frame axis L is the conv depth axis D. With subpixel_decoder the last
`subpixel_blocks` decoders (all for -1) are DecoderResidualBlock3D, whose
conv1 runs on the coarse grid (K10), as `v2ce_toolbox_tpu/models/
unet3d.py:89-103` selects them. The head, the pred conv and the 1x1
projections keep conv_impl 'xla', as there.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import (
    ConvLayer3D,
    DecoderResidualBlock3D,
    ResidualBlock3D,
    upsample_nearest_to,
)


class UNet3D(nn.Module):
    def __init__(self, num_input_channels: int = 2, num_output_channels: int = 20,
                 skip_type: str = "concat", activation: str = "relu",
                 num_encoders: int = 4, base_num_channels: int = 32,
                 num_residual_blocks: int = 2, norm: Optional[str] = "BN",
                 sn: bool = True, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", subpixel_decoder: bool = False,
                 subpixel_blocks: int = -1):
        super().__init__()
        if skip_type != "concat":
            raise NotImplementedError("only concat skips are ported")
        base = base_num_channels
        max_ch = base * 2 ** num_encoders
        cd, ci = compute_dtype, conv_impl
        self.head = ConvLayer3D(num_input_channels, base, 3, 1, 1,
                                activation="LeakyReLU", compute_dtype=cd)
        self.encoders = nn.ModuleList(
            ResidualBlock3D(base * 2 ** i, base * 2 ** (i + 1), (1, 2, 2), norm, False, cd, ci)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(
            ResidualBlock3D(max_ch, max_ch, (1, 1, 1), norm, sn, cd, ci)
            for _ in range(num_residual_blocks))

        def dec_block(i: int):
            sp = subpixel_decoder and (subpixel_blocks < 0
                                       or i >= num_encoders - subpixel_blocks)
            cls = DecoderResidualBlock3D if sp else ResidualBlock3D
            # decoder i takes concat(upsampled, skip): in = out*2 + out = 1.5x
            return cls(max_ch // 2 ** i + max_ch // 2 ** (i + 1), max_ch // 2 ** (i + 1),
                       (1, 1, 1), norm, sn, cd, ci)

        self.decoders = nn.ModuleList(dec_block(i) for i in range(num_encoders))
        self.pred = ConvLayer3D(base, num_output_channels, 1, 1, 0,
                                activation=activation, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        skips = []
        for enc in self.encoders:
            skips.append(x)
            x = enc(x)
        for res in self.resblocks:
            x = res(x)
        for dec, skip in zip(self.decoders, reversed(skips)):
            if isinstance(dec, DecoderResidualBlock3D):
                x = dec(x, skip)
            else:
                x = dec(torch.cat([upsample_nearest_to(x, skip.shape[-2:]), skip], dim=1))
        return self.pred(x)
