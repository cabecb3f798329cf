"""The research conv backends of `models/layers._apply_conv`, the port of
`v2ce_toolbox_tpu/ops/research.py`: exact rewrites of the same conv and a
profiling knockout, reached only by a ModelConfig.conv_impl other than
'xla' (the probes and the parity tests set them).

  'ko:<pred>'  knockout profiling: the 3x3x3 convs the predicate picks run
               as their centre tap, so a group's in-model cost reads off
               the model-time delta (not the same function).
  'fold'       the (1,2,2)-strided 3x3x3 conv as a stride-1 (3,2,2) conv
               of the space-to-depth phase fold (`conv3d_quad.fold_s122`).
  'd2'/'d2s'   the depth taps folded into the output channels: one 2D conv
               with 3*Co outputs over the (B*L) batch, then a shift-add
               over L; 'd2s' only where Co < 128 and C > Co.
  'wpack'      the width-packed (3,3,1) conv (`ops/wpack.py`).

'xla' and K9's 'pallas' stay inline in `models/layers._apply_conv`, which
sends every other conv_impl here.

Tensors are NCDHW, kernels (Co, C, kd, kh, kw); every backend returns
f32 and casts its inputs to compute_dtype (a bf16 conv rounds its sums to
bf16 before the cast back).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.config import CONV_IMPLS, KNOCKOUT_PREDICATES


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


def pallas_applies(x: torch.Tensor, w: torch.Tensor, stride, padding) -> bool:
    """The JAX guard of the Pallas conv (`research.py:115-119`)."""
    return (w.dim() == 5 and tuple(w.shape[2:]) == (3, 3, 3) and _triple(stride) == (1, 1, 1)
            and _triple(padding) == (1, 1, 1) and x.shape[1] >= 16)


def knockout(pred: str, w: torch.Tensor, stride) -> bool:
    """Whether conv_impl 'ko:<pred>' replaces a 3x3x3 conv (Co, C, 3, 3, 3)
    of this stride by its centre tap (`research.py:34-49`)."""
    cout, cin = w.shape[:2]
    strided = _triple(stride) != (1, 1, 1)
    preds = {
        "all": True,
        "head": cin == 2,
        "strided": strided,
        "small": (not strided) and cout < 128 and cin > 2,
        "big": (not strided) and cin >= 256,
    }
    if pred not in preds:
        raise ValueError(f"unknown knockout predicate {pred!r}; "
                         f"valid: {sorted(KNOCKOUT_PREDICATES)}")
    return preds[pred]


def depth_fold(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """'d2': the 3x3x3 conv as one 2D conv over the (B*L) batch whose
    output channels are (kd, Co), then y[l] = z[l-1, kd=0] + z[l, kd=1] +
    z[l+1, kd=2], zero outside (`research.py:80-104`). x and w in the
    compute dtype; f32 out."""
    b, c, l, h, wd = x.shape
    co = w.shape[0]
    k2 = w.permute(2, 0, 1, 3, 4).reshape(3 * co, c, 3, 3)
    x2 = x.transpose(1, 2).reshape(b * l, c, h, wd)
    z = F.conv2d(x2, k2, stride=stride[1:], padding=padding[1:]).float()
    ho, wo = z.shape[-2:]
    z = z.reshape(b, l, 3, co, ho, wo)
    y = z[:, :, 1].clone()
    y[:, 1:] += z[:, :-1, 0]
    y[:, :-1] += z[:, 1:, 2]
    return y.transpose(1, 2)


def dispatch_conv(x: torch.Tensor, w: torch.Tensor, stride, padding,
                  compute_dtype: torch.dtype, conv_impl: str) -> torch.Tensor:
    """The research backend `conv_impl` of the 3D conv of x by w (JAX
    `research.dispatch_conv`); a conv it does not apply to, and conv_impl
    'xla', run as F.conv3d. f32 out."""
    stride, padding = _triple(stride), _triple(padding)
    is333 = tuple(w.shape[2:]) == (3, 3, 3)
    same = padding == (1, 1, 1)
    cd = compute_dtype
    if conv_impl.startswith("ko:") and is333:
        if knockout(conv_impl[3:], w, stride):
            return F.conv3d(x.to(cd), w[:, :, 1:2, 1:2, 1:2].to(cd), None, stride).float()
        conv_impl = "xla"
    if conv_impl == "fold" and is333 and stride == (1, 2, 2) and same:
        from v2ce_toolbox_tpu_torch.ops.conv3d_quad import fold_s122

        # channels-last views in, channels-last fold out: the stride-1
        # (3, 2, 2) VALID conv takes it as a channels_last_3d NCDHW view
        xf, k4 = fold_s122(x.to(cd).permute(0, 2, 3, 4, 1), w.to(cd).permute(2, 3, 4, 1, 0))
        return F.conv3d(xf.permute(0, 4, 1, 2, 3), k4.permute(4, 3, 0, 1, 2)).float()
    if conv_impl == "d2s":
        cout, cin = w.shape[:2]
        conv_impl = "d2" if (cout < 128 and cin > cout) else "xla"
    if conv_impl == "d2" and is333 and stride[0] == 1 and same:
        return depth_fold(x.to(cd), w.to(cd), stride, padding)
    if conv_impl == "wpack" and is333 and stride[0] == 1 and same:
        from v2ce_toolbox_tpu_torch.ops.wpack import conv3d_wpack

        return conv3d_wpack(x, w, stride, compute_dtype=cd)
    if conv_impl == "pallas":
        raise ValueError("conv_impl 'pallas' is K9's route in models.layers._apply_conv")
    if not (conv_impl in CONV_IMPLS or conv_impl.startswith("ko:")):
        raise ValueError(f"unknown conv_impl {conv_impl!r}")
    return F.conv3d(x.to(cd), w.to(cd), None, stride, padding).float()
