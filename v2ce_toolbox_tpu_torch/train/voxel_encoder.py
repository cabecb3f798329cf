"""VoxelEncoder and EncoderLoss: the perceptual voxel-embedding loss
(`--loss encoder`).

The JAX package's `train/voxel_encoder.py` in torch: a conv downsample
stack (64 -> 128 -> 256 channels, BN, ReLU, 2x2 max pools, a global
average pool) feeding two post-norm transformer layers (d_model 256, 2
heads, feed-forward 2048, ReLU; flax's LayerNorm eps 1e-6) and a linear
head to 512-d embeddings per frame. The loss is the MSE between the pred
and GT embeddings of a frozen encoder. The reference's trained encoder
weights are not in the repository, so the encoder takes seeded random
weights or a converted flax tree (`utils/weights.voxel_encoder_from_jax_variables`).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn


class _SelfAttention(nn.Module):
    """flax MultiHeadDotProductAttention(num_heads) over (B, L, d): q, k, v
    and out projections with biases, softmax(q k^T / sqrt(head_dim)) v."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.n_heads

        def heads(t):
            return t.reshape(b, l, self.n_heads, hd).transpose(1, 2)   # (B, h, L, hd)

        q = heads(self.query(x)) / math.sqrt(hd)
        k, v = heads(self.key(x)), heads(self.value(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(b, l, d))


class _TransformerLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int = 2, d_ff: int = 2048):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class VoxelEncoder(nn.Module):
    """(B, L, H, W, 20) voxels -> (B, L, out_channels) embeddings."""

    def __init__(self, in_channels: int = 20, out_channels: int = 512, hidden_size: int = 64):
        super().__init__()
        hs = hidden_size
        for name, cin, cout in (("down0", in_channels, hs), ("down1", hs, 2 * hs),
                                ("down2", 2 * hs, 4 * hs)):
            setattr(self, f"{name}_conv", nn.Conv2d(cin, cout, 3, padding=1))
            # flax momentum 0.99 is torch's 0.01
            setattr(self, f"{name}_bn", nn.BatchNorm2d(cout, eps=1e-5, momentum=0.01))
        self.encoder_0 = _TransformerLayer(4 * hs)
        self.encoder_1 = _TransformerLayer(4 * hs)
        self.output = nn.Linear(4 * hs, out_channels)

    def _block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, h, w, c = x.shape
        x = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        x = F.max_pool2d(self._block(x, "down0"), 2, 2)
        x = F.max_pool2d(self._block(x, "down1"), 2, 2)
        x = self._block(x, "down2").mean(dim=(2, 3))    # global average pool
        x = x.reshape(b, l, -1)
        x = self.encoder_1(self.encoder_0(x))
        return self.output(x)


def init_voxel_encoder(enc: VoxelEncoder, seed: int = 0) -> None:
    """Seeded random init: weights normal with std 1/sqrt(fan_in), zero
    biases, unit norms, BN statistics (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(m.weight.shape[1:])
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in))
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()                # BN: its running statistics too


class EncoderLoss:
    """MSE between the embeddings of pred and GT under a frozen
    VoxelEncoder in eval mode (never given to an optimizer). The gradient
    reaches pred through the encoder."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0):
        self.encoder = VoxelEncoder()
        if state_dict is None:
            init_voxel_encoder(self.encoder, seed)
        else:
            self.encoder.load_state_dict(state_dict)
        self.encoder.eval().requires_grad_(False)

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        enc = self.encoder.to(pred.device)          # a no-op once it is there
        return torch.mean(torch.square(enc(pred) - enc(gt)))
