"""2D UNet and its per-frame V2CE wrapper, as torch modules (NCHW inside).

  head:      ResidualBlock2D(in -> base, stride 1, no norm, no SN)
  encoders:  ResidualBlock2D stride 2, channels x2 each, BN, no SN
  resblocks: ResidualBlock2D at the widest width, BN, SN
  decoders:  nearest upsample to the skip's (H, W), concat [x, skip] (or
             sum), ResidualBlock2D -> half the channels, BN, SN
  pred:      ConvLayer2D(-> out, k1, final activation); with `multi` one
             head after every decoder, whose prediction is concatenated
             (or summed) back into the stream

`V2ce2d` folds the frame axis of (B, L, H, W, C) into the batch and runs
the UNet per frame. Three quirks of the JAX package
(`v2ce_toolbox_tpu/models/unet2d.py`) are kept: `norm="IN"` builds a
BatchNorm, and every block has the projection shortcut (1x1 conv and BN).
The JAX modules' `compute_dtype` is not carried over: the 2D models are
f32 only, the precision the tests hold against JAX.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import (
    BatchNorm2d,
    ResidualBlock3D,
    _activation,
    _conv,
    upsample_nearest_to,
)


class ResidualBlock2D(ResidualBlock3D):
    """ResidualBlock3D with 2D convs and BatchNorms: conv1 (3x3, stride),
    bn1, relu, conv2, bn2, plus the 1x1 projection and its BN, then relu."""

    ndim = 2


class ConvLayer2D(nn.Module):
    """conv2d + optional BN (momentum 0.01, eps 1e-5) + optional activation."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, activation: Optional[str] = "LeakyReLU",
                 norm: Optional[str] = None, sn: bool = False):
        super().__init__()
        self.conv2d = _conv(cin, cout, kernel_size, stride, padding, norm != "BN", sn,
                            ndim=2)
        self.norm_layer = (BatchNorm2d(cout, eps=1e-5, momentum=0.01)
                           if norm == "BN" else None)
        self.activation = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d(x)
        if self.norm_layer is not None:
            out = self.norm_layer(out)
        if self.activation is not None:
            out = self.activation(out)
        return out


class UNet2D(nn.Module):
    def __init__(self, num_input_channels: int = 2, num_output_channels: int = 20,
                 skip_type: str = "concat", activation: str = "relu",
                 num_encoders: int = 4, base_num_channels: int = 32,
                 num_residual_blocks: int = 2, norm: Optional[str] = "BN",
                 sn: bool = True, multi: bool = False):
        super().__init__()
        base = base_num_channels
        max_ch = base * 2 ** num_encoders
        concat = skip_type == "concat"
        self.concat, self.multi = concat, multi
        self.head = ResidualBlock2D(num_input_channels, base, 1, None, False)
        self.encoders = nn.ModuleList(
            ResidualBlock2D(base * 2 ** i, base * 2 ** (i + 1), 2, norm, False)
            for i in range(num_encoders))
        self.resblocks = nn.ModuleList(
            ResidualBlock2D(max_ch, max_ch, 1, norm, sn)
            for _ in range(num_residual_blocks))
        decoders, preds = [], []
        ch = max_ch                       # the stream's channels into decoder i
        for i in range(num_encoders):
            cout = max_ch // 2 ** (i + 1)
            decoders.append(ResidualBlock2D(ch + cout if concat else ch, cout, 1, norm, sn))
            ch = cout
            if multi:
                preds.append(ConvLayer2D(ch, num_output_channels, 1, 1, 0, activation))
                ch += num_output_channels if concat else 0
        self.decoders = nn.ModuleList(decoders)
        if multi:
            self.preds = nn.ModuleList(preds)
        else:
            self.pred = ConvLayer2D(base, num_output_channels, 1, 1, 0, activation)

    def _skip(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, y], dim=1) if self.concat else x + y

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        """(N, C, H, W) -> (N, out, H, W), or with `multi` the list of every
        head's prediction, coarsest first."""
        x = self.head(x)
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
        return all_pred if self.multi else self.pred(x)


class V2ce2d(nn.Module):
    """Per-frame 2D variant: (B, L, H, W, in) -> (B, L, H, W, out), the
    UNet at base 32, 4 encoders, 2 resblocks, BN and SN. With `unet_multi`
    the last head's prediction, or every head's with `real_multi_out`."""

    def __init__(self, in_channels: int = 2, out_channels: int = 20,
                 unet_multi: bool = True, real_multi_out: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.unet_multi, self.real_multi_out = unet_multi, real_multi_out
        self.unet = UNet2D(in_channels, out_channels, "concat", "relu", 4, 32, 2, "BN",
                           True, unet_multi)

    def forward(self, image_units: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        b, l, h, w, c = image_units.shape
        out = self.unet(image_units.reshape(b * l, h, w, c).permute(0, 3, 1, 2))

        def frames(y):
            return y.permute(0, 2, 3, 1).reshape(b, l, h, w, self.out_channels)

        if self.unet_multi:
            if self.real_multi_out:
                return [frames(y) for y in out]
            out = out[-1]
        return frames(out)
