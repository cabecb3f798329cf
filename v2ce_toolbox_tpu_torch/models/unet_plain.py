"""Plain-conv 3D UNet (the non-residual twin of unet3d), NCDHW inside.

  head:      ConvLayer3D(in -> base, k3 s1 p1, LeakyReLU)
  encoders:  ConvLayer3D k3 stride (1, 2, 2) p1, channels x2 each, LeakyReLU
  resblocks: ResidualBlock3D at the widest width
  decoders:  nearest upsample to the skip's (H, W), sum (or concat) the
             skip, ConvLayer3D k3 p1 -> half the channels, LeakyReLU
  pred:      ConvLayer3D(-> out, k1, final activation); with `multi` one
             head after every decoder, whose prediction is fed back into
             the stream by the skip rule

The default skip type is 'sum', as in the JAX package
(`v2ce_toolbox_tpu/models/unet_plain.py`), and as there it fails at the
first decoder on a channel mismatch (the upsampled stream has twice the
skip's channels); 'concat' is the configuration that runs. The port does
not repair this. The JAX module's `compute_dtype` is not carried over: the
model is f32 only, the precision the tests hold against JAX.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import (
    ConvLayer3D,
    ResidualBlock3D,
    upsample_nearest_to,
)


class UNetPlain3D(nn.Module):
    def __init__(self, num_input_channels: int = 160, num_output_channels: int = 16,
                 skip_type: str = "sum", activation: Optional[str] = "sigmoid",
                 num_encoders: int = 4, base_num_channels: int = 32,
                 num_residual_blocks: int = 2, norm: Optional[str] = None,
                 sn: bool = False, multi: bool = False):
        super().__init__()
        base = base_num_channels
        max_ch = base * 2 ** num_encoders
        concat = skip_type != "sum"
        self.concat, self.multi = concat, multi
        self.head = ConvLayer3D(num_input_channels, base, 3, 1, 1, "LeakyReLU")
        self.encoders = nn.ModuleList(
            ConvLayer3D(base * 2 ** i, base * 2 ** (i + 1), 3, (1, 2, 2), 1, "LeakyReLU",
                        norm, False)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(
            ResidualBlock3D(max_ch, max_ch, (1, 1, 1), norm, sn)
            for _ in range(num_residual_blocks))
        decoders, preds = [], []
        ch = max_ch                       # the stream's channels into decoder i
        for i in range(num_encoders):
            cout = max_ch // 2 ** (i + 1)
            decoders.append(ConvLayer3D(ch + cout if concat else ch, cout, 3, 1, 1,
                                        "LeakyReLU", norm, sn))
            ch = cout
            if multi:
                preds.append(ConvLayer3D(ch, num_output_channels, 1, 1, 0, activation))
                ch += num_output_channels if concat else 0
        self.decoders = nn.ModuleList(decoders)
        if multi:
            self.preds = nn.ModuleList(preds)
        else:
            self.pred = ConvLayer3D(base, num_output_channels, 1, 1, 0, activation)

    def _skip(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, y], dim=1) if self.concat else x + y

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(B, L, H, W, in) -> (B, L, H, W, out), or with `multi` the list of
        every head's prediction, coarsest first."""
        x = self.head(x.permute(0, 4, 1, 2, 3))
        skips = []
        for enc in self.encoders:
            skips.append(x)
            x = enc(x)
        for res in self.resblocks:
            x = res(x)
        all_pred = []
        for i, skip in enumerate(reversed(skips)):
            x = self.decoders[i](self._skip(upsample_nearest_to(x, skip.shape[-2:]), skip))
            if self.multi:
                all_pred.append(self.preds[i](x))
                x = self._skip(x, all_pred[-1])
        if self.multi:
            return [y.permute(0, 2, 3, 4, 1) for y in all_pred]
        return self.pred(x).permute(0, 2, 3, 4, 1)
