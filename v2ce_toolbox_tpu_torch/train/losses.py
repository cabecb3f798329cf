"""Stage-1 training losses.

The JAX package's `train/losses.py` in torch: the same functions, names,
alphas and checks. Every function takes channels-last voxels
(B, L, H, W, 20), channel c = p*10 + bin with p = 0 the ON polarity, as
the port's V2ce3d returns them, and returns a 0-dim tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from v2ce_toolbox_tpu_torch.parallel.mesh import all_reduce_with_grad


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient: +1 at 0, where torch's abs gives 0 (the
    sparse voxels hold many exact zeros)."""
    return torch.where(x >= 0, x, -x)


def _to_bp_lc_hw(v: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W, 20) -> (B*P, L*C, H, W), the reference's
    'b l (p c) h w -> (b p) (l c) h w' rearrange."""
    b, l, h, w, c = v.shape
    v = v.reshape(b, l, h, w, 2, c // 2).permute(0, 4, 1, 5, 2, 3)
    return v.reshape(b * 2, l * (c // 2), h, w)


_POOLS = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)


def _avg_pool_nd(x: torch.Tensor, window: Tuple[int, ...], strides: Tuple[int, ...],
                 padding: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """Average pool over the trailing len(window) axes of x, zero padding
    counted in the mean (torch's count_include_pad=True); pads are
    symmetric."""
    nd = len(window)
    if any(lo != hi for lo, hi in padding):
        raise ValueError(f"asymmetric padding {padding!r}")
    lead = x.shape[:-nd]
    y = _POOLS[nd - 1](x.reshape(math.prod(lead), 1, *x.shape[-nd:]), window, strides,
                       [lo for lo, _ in padding], count_include_pad=True)
    return y.reshape(*lead, *y.shape[-nd:])


def pyramid3d_loss(pred: torch.Tensor, gt: torch.Tensor, add_base_loss: bool = False,
                   scales: Sequence[int] = (2, 4, 8)) -> torch.Tensor:
    """MSE over s x s x s average pools of the (l*c, h, w) volume, averaged
    over the scales (plus the unpooled MSE with add_base_loss)."""
    p, g = _to_bp_lc_hw(pred), _to_bp_lc_hw(gt)
    loss = _mse(p, g) if add_base_loss else 0.0
    for s in scales:
        win = (s, s, s)
        loss = loss + _mse(_avg_pool_nd(p, win, win, ((0, 0),) * 3),
                           _avg_pool_nd(g, win, win, ((0, 0),) * 3))
    return loss / len(scales)


def pyramid_temporal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """MSE over 1-D average pools (3 with pad 1, and 5) of the temporal
    (l*c) axis, plus the unpooled MSE, halved."""
    def prep(v):
        x = _to_bp_lc_hw(v)                        # (N, D, H, W)
        n, d, h, w = x.shape
        return x.reshape(n, d, h * w).transpose(1, 2)    # (N, HW, D)

    p, g = prep(pred), prep(gt)
    loss = _mse(p, g)
    loss = loss + _mse(_avg_pool_nd(p, (3,), (3,), ((1, 1),)),
                       _avg_pool_nd(g, (3,), (3,), ((1, 1),)))
    loss = loss + _mse(_avg_pool_nd(p, (5,), (5,), ((0, 0),)),
                       _avg_pool_nd(g, (5,), (5,), ((0, 0),)))
    return loss / 2.0


def event_frame_loss(pred: torch.Tensor, gt: torch.Tensor, *, split_polarity: bool,
                     ef_type: str = "c+cl", alpha_efc: float = 5.0) -> torch.Tensor:
    """Event-frame MSE over bin/frame-collapsed voxels. The voxel is seen
    as (B, L, C20, H, W) for 'ef' and (B, L, C10, P, H, W) for 'ef_splitp';
    'cl' sums dims (1, 2), 'only_c' dim 2, 'c+cl' weighs 'only_c' by
    alpha_efc and adds 'cl'."""
    b, l, h, w, c = pred.shape
    if split_polarity:
        pv = pred.reshape(b, l, h, w, 2, c // 2).permute(0, 1, 5, 4, 2, 3)
        gv = gt.reshape(b, l, h, w, 2, c // 2).permute(0, 1, 5, 4, 2, 3)
    else:
        pv = pred.permute(0, 1, 4, 2, 3)
        gv = gt.permute(0, 1, 4, 2, 3)

    if ef_type == "cl":
        return _mse(_abs(pv).sum(dim=(1, 2)), _abs(gv).sum(dim=(1, 2)))
    if ef_type == "only_c":
        return _mse(_abs(pv).sum(dim=2), _abs(gv).sum(dim=2))
    if ef_type == "c+cl":
        loss_c = _mse(_abs(pv).sum(dim=2), _abs(gv).sum(dim=2))
        loss_cl = _mse(_abs(pv).sum(dim=(1, 2)), _abs(gv).sum(dim=(1, 2)))
        return alpha_efc * loss_c + loss_cl
    raise ValueError(f"invalid ef_type {ef_type!r}")


def match_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """NLL over the frame axis L against the GT's argmax frame (the first
    on ties)."""
    pv = pred.permute(0, 1, 4, 2, 3)               # (B, L, C, H, W)
    gv = gt.permute(0, 1, 4, 2, 3)
    logp = F.log_softmax(pv, dim=1)
    target = torch.argmax(gv, dim=1)               # (B, C, H, W)
    picked = torch.take_along_dim(logp, target[:, None], dim=1)[:, 0]
    return -torch.mean(picked)


def compensation_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """MSE of the masked (> 0.01) mean activity over dims (2, 3) of the
    (B, L, C, H, W) layout (C and H, keeping W, as the reference does)."""
    def masked_mean(v):
        v = v.permute(0, 1, 4, 2, 3)
        mask = v > 0.01
        s = torch.sum(v * mask, dim=(2, 3), keepdim=True)
        n = torch.clamp(torch.sum(mask, dim=(2, 3), keepdim=True), min=1)
        return s / n

    return _mse(masked_mean(pred), masked_mean(gt))


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(_abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return _mse(pred, gt)


def norm_l1(pred: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum of |pred|. A sum, not a mean, over the batch: under a
    data-parallel `mesh` this rank's sum is scaled by the rank count, so
    the mean over the ranks (of the term and of its gradient) is the
    global batch's."""
    s = torch.sum(_abs(pred))
    return s if mesh is None else s * mesh.size


def norm_l2(pred: torch.Tensor, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares; under a `mesh` the sum runs over the
    global batch (an all_reduce with autograd), so every rank holds the
    global value."""
    s = torch.sum(torch.square(pred))
    if mesh is not None:
        s = all_reduce_with_grad(s)
    return torch.sqrt(s)


#: Every composable loss name; anything else raises ValueError.
KNOWN_LOSS_NAMES = frozenset({
    "imu", "physical", "ef", "ef_splitp", "encoder", "pyramid", "pt",
    "gan", "match", "compensation", "l1", "l2", "norml1", "norml2",
})

DEFAULT_ALPHAS: Dict[str, float] = {
    "alpha_imu": 1.0,
    "alpha_att": 10.0,
    "alpha_gan": 1.0,
    "alpha_pyramid": 1000.0,
    "alpha_ef": 0.5,
    "alpha_encoder": 1.0,
    "alpha_efc": 5.0,
    "alpha_match": 0.5,
    "alpha_compensation": 1.0,
    "alpha_pt": 1.0,
    "alpha_norm": 1e-5,
}


def compose_losses(
    pred: torch.Tensor,
    gt: torch.Tensor,
    loss_names: Sequence[str],
    *,
    ef_type: str = "c+cl",
    add_base_loss: bool = False,
    alphas: Dict[str, float] = DEFAULT_ALPHAS,
    gan_loss_value: torch.Tensor = None,
    encoder_loss_fn=None,
    pred_extras: Dict[str, torch.Tensor] = None,
    batch: Dict[str, torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(weighted sum, {term: value}) of the named losses, in the JAX
    function's order and with its checks. The GAN's generator term comes
    in as `gan_loss_value` (the step owns the discriminator); `pred_extras`
    and `batch` carry the 'imu' and 'physical_att(s)' outputs and targets
    of multi-output models ('physical' is skipped without attention maps,
    'imu' raises without both sides); 'encoder' needs `encoder_loss_fn`.
    Unknown names raise ValueError. Under a data-parallel `mesh` each term
    is this rank's share, whose mean over the ranks is the global batch's
    value: the means over equal blocks as they are, the norms as
    `norm_l1` / `norm_l2` say."""
    unknown = set(loss_names) - KNOWN_LOSS_NAMES
    if unknown:
        raise ValueError(
            f"Invalid loss type(s) {sorted(unknown)!r}; "
            f"known: {sorted(KNOWN_LOSS_NAMES)}")
    a = {**DEFAULT_ALPHAS, **alphas}
    pred_extras = pred_extras or {}
    batch = batch or {}
    total = 0.0
    logs: Dict[str, torch.Tensor] = {}

    if "imu" in loss_names:
        if "imu" not in pred_extras or "imu" not in batch:
            raise ValueError(
                "--loss imu needs a model emitting pred_extras['imu'] and a "
                "batch carrying 'imu' targets")
        v = _mse(pred_extras["imu"], batch["imu"])
        total += a["alpha_imu"] * v
        logs["imu_loss"] = v

    if "physical" in loss_names and pred_extras.get("physical_atts"):
        gt_att = batch["physical_att"]
        atts = pred_extras["physical_atts"]
        v = sum(_mse(att, gt_att) for att in atts) / len(atts)
        total += a["alpha_att"] * v
        logs["att_loss"] = v

    ef_terms = []
    if "ef" in loss_names:
        ef_terms.append(event_frame_loss(pred, gt, split_polarity=False, ef_type=ef_type,
                                         alpha_efc=a["alpha_efc"]))
    if "ef_splitp" in loss_names:
        ef_terms.append(2.0 * event_frame_loss(pred, gt, split_polarity=True,
                                               ef_type=ef_type, alpha_efc=a["alpha_efc"]))
    if ef_terms:
        ef = sum(ef_terms) / len(ef_terms)
        total += a["alpha_ef"] * ef
        logs["ef_loss"] = ef

    if "pyramid" in loss_names:
        v = pyramid3d_loss(pred, gt, add_base_loss=add_base_loss)
        total += a["alpha_pyramid"] * v
        logs["pyramid_loss"] = v
    if "pt" in loss_names:
        # weighted by alpha_pyramid, as the reference does (alpha_pt only
        # shows in its log line)
        v = pyramid_temporal_loss(pred, gt)
        total += a["alpha_pyramid"] * v
        logs["pt_loss"] = v
    if "encoder" in loss_names:
        if encoder_loss_fn is None:
            raise ValueError(
                "--loss encoder needs an EncoderLoss instance "
                "(train.voxel_encoder.EncoderLoss) passed as encoder_loss_fn")
        v = encoder_loss_fn(pred, gt)
        total += a["alpha_encoder"] * v
        logs["encoder_loss"] = v
    if "match" in loss_names:
        v = match_loss(pred, gt)
        total += a["alpha_match"] * v
        logs["match"] = v
    if "compensation" in loss_names:
        v = compensation_loss(pred, gt)
        total += a["alpha_compensation"] * v
        logs["compensation"] = v
    if "l1" in loss_names:
        v = l1_loss(pred, gt)
        total += v
        logs["l1"] = v
    if "l2" in loss_names:
        v = l2_loss(pred, gt)
        total += v
        logs["l2"] = v
    if "norml1" in loss_names:
        v = norm_l1(pred, mesh)
        total += a["alpha_norm"] * v
        logs["norml1"] = v
    if "norml2" in loss_names:
        v = norm_l2(pred, mesh)
        total += a["alpha_norm"] * v
        logs["norml2"] = v
    if "gan" in loss_names and gan_loss_value is not None:
        total += a["alpha_gan"] * gan_loss_value
        logs["gan_loss"] = gan_loss_value

    return total, logs
