"""PatchGAN discriminator and adversarial loss for stage-1 training.

The JAX package's `train/gan.py` in torch. The discriminator has no norm
layers: convs k4 s2 p1 -> 64/128/256, then k4 s1 p1 -> 512 -> 1, each
but the last followed by leaky ReLU 0.2; the 3D variant pads 2. It takes
and returns channels-last tensors, as the flax module does.

The discriminator keeps its own Adam optimizer. A train step first runs
`discriminator_update` (`gan_k` updates on the detached fake and the
real voxels), then `generator_adversarial_loss` with the updated
discriminator, whose parameters take no gradient from that term.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from v2ce_toolbox_tpu_torch.parallel.mesh import average_gradients


class _PatchDiscriminator(nn.Module):
    conv = nn.Conv2d
    padding = 1

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        chans = [in_channels, ndf] + [ndf * min(2 ** n, 8) for n in range(1, n_layers + 1)]
        strides = [2] * n_layers + [1]
        self.convs = nn.ModuleList(
            self.conv(cin, cout, 4, stride, self.padding)
            for cin, cout, stride in zip(chans[:-1], chans[1:], strides))
        self.convs.append(self.conv(chans[-1], 1, 4, 1, self.padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.movedim(-1, 1)                       # channels-last -> channels-first
        for conv in self.convs[:-1]:
            x = F.leaky_relu(conv(x), 0.2)
        return self.convs[-1](x).movedim(1, -1)


class PatchDiscriminator2D(_PatchDiscriminator):
    """(N, H, W, 20) -> (N, H', W', 1) patch logits."""

    def __init__(self, in_channels: int = 20, ndf: int = 64, n_layers: int = 3):
        super().__init__(in_channels, ndf, n_layers)


class PatchDiscriminator3D(_PatchDiscriminator):
    """(N, C10, H, W, P) -> (N, C', H', W', 1) patch logits (k4, pad 2)."""

    conv = nn.Conv3d
    padding = 2

    def __init__(self, in_channels: int = 2, ndf: int = 64, n_layers: int = 3):
        super().__init__(in_channels, ndf, n_layers)


def make_discriminator(use_3d_conv: bool = False) -> nn.Module:
    return PatchDiscriminator3D() if use_3d_conv else PatchDiscriminator2D()


def init_discriminator(disc: nn.Module, seed: int = 0) -> None:
    """Seeded random init: kernels normal with std 1/sqrt(fan_in) (flax's
    lecun-normal scale), zero biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in disc.convs:
            w = conv.weight
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(math.prod(w.shape[1:])))
            conv.bias.zero_()


def make_disc_optimizer(params) -> torch.optim.Optimizer:
    """Adam(lr 1e-5, betas (0, 0.9), eps 1e-8, weight_decay 1e-5): the
    additive L2 before Adam of the JAX chain."""
    return torch.optim.Adam(params, lr=1e-5, betas=(0.0, 0.9), eps=1e-8, weight_decay=1e-5)


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy against a constant label, in
    optax's form: -t log sigmoid(x) - (1 - t) log sigmoid(-x)."""
    return torch.mean(-target * F.logsigmoid(logits) - (1.0 - target) * F.logsigmoid(-logits))


def _prep(voxels: torch.Tensor, use_3d_conv: bool) -> torch.Tensor:
    """Channels-last model voxels (B, L, H, W, 20) -> discriminator input:
    frames into the batch, and for 3D the polarity split off the channels."""
    b, l, h, w, c = voxels.shape
    x = voxels.reshape(b * l, h, w, c)
    if not use_3d_conv:
        return x                                   # (N, H, W, 20)
    x = x.reshape(b * l, h, w, 2, c // 2)          # split polarity
    return x.permute(0, 4, 1, 2, 3)                # (N, C10, H, W, P)


def discriminator_update(disc: nn.Module, optimizer: torch.optim.Optimizer,
                         fake_voxels: torch.Tensor, real_voxels: torch.Tensor, *,
                         gan_k: int = 3, use_3d_conv: bool = False, mesh=None) -> torch.Tensor:
    """`gan_k` BCE updates of the discriminator on the detached fake (label
    0) and real (label 1) voxels. Returns the mean d_loss (detached), this
    rank's under a data-parallel `mesh`, where each update's gradients are
    averaged over the ranks first: the gradient of the global-batch loss."""
    fake = _prep(fake_voxels.detach(), use_3d_conv)
    real = _prep(real_voxels.detach(), use_3d_conv)
    total = 0.0
    for _ in range(gan_k):
        optimizer.zero_grad(set_to_none=True)
        d_loss = _bce_logits(disc(fake), 0.0) + _bce_logits(disc(real), 1.0)
        d_loss.backward()
        average_gradients(disc.parameters(), mesh)
        optimizer.step()
        total = total + d_loss.detach()
    return total / gan_k


def generator_adversarial_loss(disc: nn.Module, fake_voxels: torch.Tensor, *,
                               use_3d_conv: bool = False) -> torch.Tensor:
    """BCE(disc(fake), real label): the gradient reaches the generator
    through `fake_voxels`; the discriminator's parameters record none."""
    params = list(disc.parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        logits = disc(_prep(fake_voxels, use_3d_conv))
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)
    return _bce_logits(logits, 1.0)
