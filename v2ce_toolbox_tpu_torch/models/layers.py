"""Building blocks of the V2ce3d stage-1 model, as torch modules (NCDHW).

Submodule and parameter names follow the reference torch state_dict (the
keys `v2ce_toolbox_tpu/utils/torch_compat.py` converts), so a released
`v2ce_3d.pt` loads as it is:

  ConvLayer3D:      conv3d.{weight,bias}
  ResidualBlock3D:  conv1, bn1, conv2, bn2, downsample.0 (1x1x1 conv),
                    downsample.1 (BN); with spectral norm conv1/conv2 are
                    SNConv3d: module.{weight_bar,weight_u,weight_v}
  DecoderResidualBlock3D: the same names

Precision follows the JAX package: every conv casts its input and kernel
to `compute_dtype` and returns f32 (the bias is added in f32), and each
BatchNorm computes in f32 and returns `compute_dtype`, so the activations
between layers are bf16 in the bf16 model. Parameters, the spectral-norm
sigma and the BN statistics stay f32.

The convs, the spectral norm and the BatchNorm take any spatial rank, as
the JAX package's `Conv`, `SNConv` and `BatchNorm` do: `Conv2d`,
`SNConv2d` and `BatchNorm2d` (NCHW) share the 3D code, for the 2D UNet
(`models/unet2d.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from v2ce_toolbox_tpu_torch.ops.conv3d import conv3d_3x3x3
from v2ce_toolbox_tpu_torch.ops.decoder import fused_up_concat_conv


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def _apply_conv(x: torch.Tensor, w: torch.Tensor, stride, padding,
                compute_dtype: torch.dtype, conv_impl: str) -> torch.Tensor:
    """Conv of NCDHW x by a (Co, C, kd, kh, kw) kernel (or of NCHW x by a
    (Co, C, kh, kw) one), both cast to compute_dtype, f32 out, no bias.
    conv_impl 'pallas' sends the 3D convs that the JAX package's guard
    sends to its Pallas kernel (3x3x3, stride 1, padding 1, cin >= 16;
    `ops/research.py:115-119`) to K9, on a channels-last view; every other
    conv goes to F.conv3d (F.conv2d). These return compute_dtype, so a
    bf16 conv there rounds its f32 sums to bf16 before the cast back,
    where XLA returns them in f32."""
    if w.dim() == 4:
        return F.conv2d(x.to(compute_dtype), w.to(compute_dtype), None, stride,
                        padding).float()
    if (conv_impl == "pallas" and tuple(w.shape[2:]) == (3, 3, 3)
            and _triple(stride) == (1, 1, 1) and _triple(padding) == (1, 1, 1)
            and x.shape[1] >= 16):
        xc = x.to(compute_dtype).contiguous(memory_format=torch.channels_last_3d)
        y = conv3d_3x3x3(xc.permute(0, 2, 3, 4, 1),
                         w.to(compute_dtype).permute(2, 3, 4, 1, 0), out_dtype=torch.float32)
        return y.permute(0, 4, 1, 2, 3)
    return F.conv3d(x.to(compute_dtype), w.to(compute_dtype), None, stride,
                    padding).float()


class _FlaxTrainBN:
    """The train-mode forward of flax's `nn.BatchNorm`, as the JAX package
    trains it, over a torch BatchNorm of any rank (same parameters,
    buffers and eval path): the batch variance is mean(x^2) - mean(x)^2,
    clipped at 0, and the running variance moves toward that biased
    variance (torch's own moves toward the unbiased one, n/(n-1) times
    larger). The output is (x - mean) * (rsqrt(var + eps) * weight) + bias,
    in flax's op order; gradients flow through the batch mean and
    variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class BatchNorm3d(_FlaxTrainBN, nn.BatchNorm3d):
    """nn.BatchNorm3d with flax's train-mode forward (`_FlaxTrainBN`)."""


class BatchNorm2d(_FlaxTrainBN, nn.BatchNorm2d):
    """nn.BatchNorm2d with flax's train-mode forward (`_FlaxTrainBN`); its
    eval path is nn.BatchNorm2d's, which takes the 4-D input that
    nn.BatchNorm3d's refuses."""


_BATCHNORM = {2: BatchNorm2d, 3: BatchNorm3d}


def _bn(bn: nn.Module, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """BatchNorm in f32, output in compute_dtype."""
    return bn(x.float()).to(compute_dtype)


def _bias(b: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """A (C,) bias broadcast over NC and `ndim` spatial axes."""
    return b.view(1, -1, *(1,) * ndim)


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class _SNParams(nn.Module):
    """Holder of a spectrally normalised conv's tensors (the reference's
    wrapped module): weight_bar, the power-iteration vectors weight_u /
    weight_v, and the bias if any."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool, ndim: int = 3):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.empty(cout, cin, *(k,) * ndim))
        self.weight_u = nn.Parameter(torch.empty(cout), requires_grad=False)
        self.weight_v = nn.Parameter(torch.empty(cin * k ** ndim), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class SNConv3d(nn.Module):
    """Conv3d with the reference's spectral norm: one power iteration from
    the stored (u, v) on every forward, sigma from the updated vectors, the
    kernel divided by sigma. u and v are written back only in training
    mode; in eval nothing mutates. Gradients flow through the power
    iteration (u and v are functions of weight_bar), as in the JAX
    package's SNConv; the iteration starts from a copy of the stored u, so
    writing the new vectors back leaves the tensors autograd saved intact."""

    ndim = 3

    def __init__(self, cin: int, cout: int, k: int, stride=1, padding=0,
                 bias: bool = True, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla"):
        super().__init__()
        self.module = _SNParams(cin, cout, k, bias, self.ndim)
        self.stride = stride
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.conv_impl = conv_impl

    def weight(self) -> torch.Tensor:
        m = self.module
        w2d = m.weight_bar.reshape(m.weight_bar.shape[0], -1)
        v = _l2normalize(w2d.t() @ m.weight_u.clone())
        u = _l2normalize(w2d @ v)
        sigma = u @ (w2d @ v)
        if self.training:
            with torch.no_grad():
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
        return m.weight_bar / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_conv(x, self.weight(), self.stride, self.padding,
                        self.compute_dtype, self.conv_impl)
        return y if self.module.bias is None else y + _bias(self.module.bias, self.ndim)


class SNConv2d(SNConv3d):
    """SNConv3d's spectral norm on a 2D conv (NCHW)."""

    ndim = 2


class _ApplyConv:
    """A torch conv of any rank (same parameters) through `_apply_conv`:
    f32 out."""

    def __init__(self, cin: int, cout: int, k: int, stride=1, padding=0,
                 bias: bool = True, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "xla"):
        super().__init__(cin, cout, k, stride, padding, bias=bias)
        self.compute_dtype = compute_dtype
        self.conv_impl = conv_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _apply_conv(x, self.weight, self.stride, self.padding,
                        self.compute_dtype, self.conv_impl)
        return y if self.bias is None else y + _bias(self.bias, x.dim() - 2)


class Conv3d(_ApplyConv, nn.Conv3d):
    """nn.Conv3d through `_apply_conv`."""


class Conv2d(_ApplyConv, nn.Conv2d):
    """nn.Conv2d through `_apply_conv`."""


_CONV = {(3, False): Conv3d, (3, True): SNConv3d, (2, False): Conv2d, (2, True): SNConv2d}


def _conv(cin: int, cout: int, k: int, stride, padding, bias: bool, sn: bool,
          compute_dtype: torch.dtype = torch.float32, conv_impl: str = "xla",
          ndim: int = 3):
    return _CONV[ndim, sn](cin, cout, k, stride, padding, bias, compute_dtype, conv_impl)


def _activation(name: Optional[str]):
    if name is None:
        return None
    if name == "LeakyReLU":
        return nn.LeakyReLU(0.01)
    if name == "relu":
        return nn.ReLU()
    if name == "sigmoid":
        return nn.Sigmoid()
    if name == "tanh":
        return nn.Tanh()
    raise ValueError(f"unknown activation {name!r}")


class ConvLayer3D(nn.Module):
    """conv3d + optional BN (momentum 0.01, eps 1e-5) + optional activation."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride=1,
                 padding: int = 0, activation: Optional[str] = "LeakyReLU",
                 norm: Optional[str] = None, sn: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv3d = _conv(cin, cout, kernel_size, stride, padding, norm != "BN", sn,
                            compute_dtype)
        self.norm_layer = (BatchNorm3d(cout, eps=1e-5, momentum=0.01)
                           if norm == "BN" else None)
        self.activation = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3d(x)
        if self.norm_layer is not None:
            out = _bn(self.norm_layer, out, self.compute_dtype)
        if self.activation is not None:
            out = self.activation(out)
        return out


class ResidualBlock3D(nn.Module):
    """conv-bn-relu-conv-bn plus a projection shortcut (1x1x1 conv with bias
    and BN) on every block, as the reference builds it. `ndim` is set by
    the 2D block (`models/unet2d.ResidualBlock2D`)."""

    ndim = 3

    def __init__(self, cin: int, cout: int, stride: Tuple[int, int, int] = (1, 1, 1),
                 norm: Optional[str] = None, sn: bool = False,
                 compute_dtype: torch.dtype = torch.float32, conv_impl: str = "xla"):
        super().__init__()
        bias, nd, bn = norm != "BN", self.ndim, _BATCHNORM[self.ndim]
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(cin, cout, 3, stride, 1, bias, sn, compute_dtype, conv_impl, nd)
        self.conv2 = _conv(cout, cout, 3, 1, 1, bias, sn, compute_dtype, conv_impl, nd)
        with_bn = norm in ("BN", "IN")
        self.bn1 = bn(cout, eps=1e-5, momentum=0.1) if with_bn else None
        self.bn2 = bn(cout, eps=1e-5, momentum=0.1) if with_bn else None
        self.downsample = nn.Sequential(
            _conv(cin, cout, 1, stride, 0, True, False, compute_dtype, ndim=nd),
            bn(cout, eps=1e-5, momentum=0.1))

    def _norm(self, bn: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
        return x if bn is None else _bn(bn, x, self.compute_dtype)

    def _tail(self, out: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        """relu(bn1(out)) -> conv2 -> bn2, plus the projection's BN."""
        out = self.conv2(F.relu(self._norm(self.bn1, out)))
        out = self._norm(self.bn2, out)
        return F.relu(out + _bn(self.downsample[1], residual, self.compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._tail(self.conv1(x), self.downsample[0](x))


class DecoderResidualBlock3D(ResidualBlock3D):
    """ResidualBlock3D over concat(nearest_up2(coarse), skip) with conv1
    (and, where 4*Co <= 128, the projection) computed by K10 on the coarse
    grid, without the upsampled or the concatenated tensor: the JAX
    package's `DecoderResidualBlock3D` with subpixel_impl='pallas'
    (`v2ce_toolbox_tpu/models/layers.py:440-533`). Same parameters and
    names as ResidualBlock3D on the concat input. K10 returns
    compute_dtype; without the fused projection (Co = 64) the residual is
    the coarse 1x1 conv, upsampled (a 1x1 conv commutes with nearest
    upsampling), plus the skip's 1x1 conv."""

    def forward(self, coarse: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """coarse (B, Cu, L, hc, wc) and skip (B, Cs, L, hf, wf), hf in
        {2hc, 2hc-1} and wf in {2wc, 2wc-1}, as the UNet's halvings give."""
        th, tw = skip.shape[-2:]
        cd = self.compute_dtype
        cu = coarse.shape[1]
        conv1, proj = self.conv1, self.downsample[0]
        k1 = (conv1.weight() if isinstance(conv1, SNConv3d) else conv1.weight).to(cd)
        bias1 = conv1.module.bias if isinstance(conv1, SNConv3d) else conv1.bias
        kd = proj.weight.to(cd)
        co = k1.shape[0]

        def cl(t):          # NCDHW -> NDHWC in compute_dtype
            return t.to(cd).permute(0, 2, 3, 4, 1)

        kernel = k1.permute(2, 3, 4, 1, 0)
        if 4 * co <= 128:
            out, res = fused_up_concat_conv(cl(coarse), cl(skip), kernel,
                                            kd.permute(2, 3, 4, 1, 0), out_dtype=cd)
            residual = res.permute(0, 4, 1, 2, 3) + _bias(proj.bias)
        else:
            out = fused_up_concat_conv(cl(coarse), cl(skip), kernel, out_dtype=cd)
            residual = (upsample_nearest_to(_apply_conv(coarse, kd[:, :cu], 1, 0, cd, "xla"),
                                            (th, tw))
                        + _apply_conv(skip, kd[:, cu:], 1, 0, cd, "xla") + _bias(proj.bias))
        out = out.permute(0, 4, 1, 2, 3)
        if bias1 is not None:
            out = out + _bias(bias1)
        return self._tail(out, residual)


def upsample_nearest_to(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of (B, C, L, H, W), or of (B, C, H, W), to a target
    (H, W) with the index convention src = floor(dst * in / out), in
    integer arithmetic."""
    th, tw = target_hw
    h, w = x.shape[-2:]
    hi = torch.arange(th, device=x.device) * h // th
    wi = torch.arange(tw, device=x.device) * w // tw
    return x.index_select(x.dim() - 2, hi).index_select(x.dim() - 1, wi)
