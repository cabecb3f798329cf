"""V2ce3d — the stage-1 model: (B, L, H, W, 2) consecutive-frame pairs ->
(B, L, H, W, 20) event-count voxels (channel p*10 + bin, p = 0 is ON)."""

from __future__ import annotations

import torch
from torch import nn

from v2ce_toolbox_tpu_torch.config import ModelConfig
from v2ce_toolbox_tpu_torch.models.unet3d import UNet3D


class V2ce3d(nn.Module):
    def __init__(self, config: ModelConfig = ModelConfig()):
        super().__init__()
        self.config = config
        self.UNet = UNet3D(
            num_input_channels=config.in_channels,
            num_output_channels=config.out_channels,
            skip_type=config.skip_type,
            activation=config.final_activation,
            num_encoders=config.num_encoders,
            base_num_channels=config.base_num_channels,
            num_residual_blocks=config.num_residual_blocks,
            norm=config.norm,
            sn=config.spectral_norm,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, H, W, 2) -> (B, L, H, W, 20); NCDHW inside."""
        y = self.UNet(x.permute(0, 4, 1, 2, 3).contiguous())
        return y.permute(0, 2, 3, 4, 1)
