"""ResNet classifier, the GAN's non-patch discriminator backbone.

conv7 s2 -> BN -> LeakyReLU -> maxpool 3 s2 -> 4 stages of LeakyReLU
residual blocks ([3, 4, 6, 3] at 64/128/256/512) -> global average pool ->
linear head. It follows the JAX package's flax modules
(`v2ce_toolbox_tpu/models/resnet.py`), not torchvision's: every conv has a
bias; the BatchNorms are flax's (momentum 0.9, i.e. torch momentum 0.1,
eps 1e-5, flax's train mode); the 1x1 projection pads nothing; LeakyReLU
has slope 0.01 and the max pool pads with -inf. Input and output are
channels-last, (N, H, W, C) -> (N, classes); NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from v2ce_toolbox_tpu_torch.models.layers import BatchNorm2d


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class _ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        self.bn2 = _bn(cout)
        self.project = stride != 1 or cin != cout
        if self.project:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride, 0)
            self.downsample_bn = _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        out = self.bn2(self.conv2(out))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.project else x
        return F.leaky_relu(out + residual, 0.01)


class ResNet(nn.Module):
    def __init__(self, num_classes: int = 10, layers: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 20):
        super().__init__()
        self.stem = nn.Conv2d(in_channels, 64, 7, 2, 3)
        self.stem_bn = _bn(64)
        blocks, cin = nn.Sequential(), 64
        for stage, (feats, n_blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            for b in range(n_blocks):
                blocks.add_module(f"stage{stage}_block{b}",
                                  _ResBlock(cin, feats, stride if b == 0 else 1))
                cin = feats
        self.blocks = blocks
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.stem_bn(self.stem(x.permute(0, 3, 1, 2))), 0.01)
        x = self.blocks(F.max_pool2d(x, 3, 2, 1))
        return self.fc(x.mean(dim=(2, 3)))


class ResNetDiscriminator(nn.Module):
    """(N, H, W, C) -> (N, 2) logits."""

    def __init__(self, in_channels: int = 20):
        super().__init__()
        self.resnet = ResNet(num_classes=2, in_channels=in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet(x)
