"""3D UNet for event-voxel prediction (concat skips), NCDHW.

  head:      ConvLayer3D(in -> base, k3 s1 p1, LeakyReLU)
  encoders:  ResidualBlock3D stride (1,2,2), channels x2 each, BN, no SN
  resblocks: ResidualBlock3D at the widest width, BN, SN
  decoders:  nearest upsample to the skip's (H, W), concat [x, skip],
             ResidualBlock3D -> half the channels, BN, SN
  pred:      ConvLayer3D(base -> out, k1, final activation)

The frame axis L is the conv depth axis D. With subpixel_decoder the last
`subpixel_blocks` decoders (all for -1) are DecoderResidualBlock3D, whose
conv1 runs on the coarse grid (subpixel_impl), where the skip's (H, W) is
2h or 2h-1 of the coarse input's on each axis, as `v2ce_toolbox_tpu/
models/unet3d.py:86-102` selects them; a decoder that is not, or a target
outside that gate, upsamples and concats, or with decoder_split runs
SplitInputResidualBlock3D on the two tensors. The head, the pred conv and
the 1x1 projections keep conv_impl 'xla', as there. out_layout 'cm' returns
the prediction as (B, L, C, H, W), contiguous in that layout. remat
checkpoints the encoder, residual and decoder blocks
(`torch.utils.checkpoint`, non-reentrant, with `layers.remat_contexts`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from v2ce_toolbox_tpu_torch.models.layers import (
    ConvLayer3D,
    DecoderResidualBlock3D,
    ResidualBlock3D,
    SplitInputResidualBlock3D,
    remat_contexts,
    upsample_nearest_to,
)


class UNet3D(nn.Module):
    def __init__(self, num_input_channels: int = 2, num_output_channels: int = 20,
                 skip_type: str = "concat", activation: str = "relu",
                 num_encoders: int = 4, base_num_channels: int = 32,
                 num_residual_blocks: int = 2, norm: Optional[str] = "BN",
                 sn: bool = True, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla", subpixel_decoder: bool = False,
                 subpixel_blocks: int = -1, subpixel_impl: str = "pfold",
                 decoder_split: bool = False, out_layout: str = "cl", remat: bool = False):
        super().__init__()
        if skip_type != "concat":
            raise NotImplementedError("only concat skips are ported")
        self.decoder_split, self.out_layout, self.remat = decoder_split, out_layout, remat
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
            # decoder i takes concat(upsampled, skip): in = out*2 + out = 1.5x
            args = (max_ch // 2 ** i + max_ch // 2 ** (i + 1), max_ch // 2 ** (i + 1),
                    (1, 1, 1), norm, sn, cd, ci)
            if subpixel_decoder and (subpixel_blocks < 0 or i >= num_encoders - subpixel_blocks):
                return DecoderResidualBlock3D(*args, subpixel_impl=subpixel_impl)
            return (SplitInputResidualBlock3D if decoder_split else ResidualBlock3D)(*args)

        self.decoders = nn.ModuleList(dec_block(i) for i in range(num_encoders))
        self.pred = ConvLayer3D(base, num_output_channels, 1, 1, 0, activation=activation,
                                compute_dtype=cd)

    def _block(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, context_fn=remat_contexts)
        return fn(*args)

    def _decode(self, dec: nn.Module, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        (h, w), (th, tw) = x.shape[-2:], skip.shape[-2:]
        if (isinstance(dec, DecoderResidualBlock3D)
                and th in (2 * h, 2 * h - 1) and tw in (2 * w, 2 * w - 1)):
            return self._block(dec, x, skip)
        up = upsample_nearest_to(x, (th, tw))
        if self.decoder_split:
            return self._block(functools.partial(SplitInputResidualBlock3D.forward, dec),
                               up, skip)
        return self._block(functools.partial(ResidualBlock3D.forward, dec),
                           torch.cat([up, skip], dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, L, H, W) -> (B, Co, L, H, W), or (B, L, Co, H, W) with
        out_layout 'cm'."""
        x = self.head(x)
        skips = []
        for enc in self.encoders:
            skips.append(x)
            x = self._block(enc, x)
        for res in self.resblocks:
            x = self._block(res, x)
        for dec, skip in zip(self.decoders, reversed(skips)):
            x = self._decode(dec, x, skip)
        y = self.pred(x)
        return y.transpose(1, 2).contiguous() if self.out_layout == "cm" else y
