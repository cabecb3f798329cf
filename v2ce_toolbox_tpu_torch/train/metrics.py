"""Evaluation metrics for voxel prediction quality.

The JAX package's `train/metrics.py` in torch: the same functions and
metric names, on channels-last voxels (B, L, H, W, 20) with channel
c = p*10 + bin. Each returns a 0-dim f32 tensor.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from v2ce_toolbox_tpu_torch.train.losses import _avg_pool_nd, _to_bp_lc_hw


def _reduce(v: torch.Tensor, op_type: str) -> torch.Tensor:
    """'raw' keeps the voxel; 'sum_c' sums time bins per polarity; 'sum_cp'
    sums bins and polarities."""
    if op_type == "raw":
        return v
    b, l, h, w, c = v.shape
    split = v.reshape(b, l, h, w, 2, c // 2)
    if op_type == "sum_c":
        return split.sum(dim=-1)               # (B, L, H, W, P)
    if op_type == "sum_cp":
        return split.sum(dim=(-2, -1))         # (B, L, H, W)
    raise ValueError(f"invalid op_type {op_type!r}")


def binary_match(pred: torch.Tensor, y: torch.Tensor, op_type: str = "raw",
                 threshold: float = 0.01) -> torch.Tensor:
    """Share of voxels whose occupancy (> threshold) agrees."""
    p = _reduce(pred, op_type) > threshold
    g = _reduce(y, op_type) > threshold
    return (p == g).float().mean()


def f1score(pred_binary: torch.Tensor, y_binary: torch.Tensor, mesh=None) -> torch.Tensor:
    """F1 on {0,1} arrays. A ratio of batch sums: under a data-parallel
    `mesh` tp, fp and fn are summed over the ranks first, so every rank
    holds the global batch's F1."""
    pred_binary = pred_binary.float()
    y_binary = y_binary.float()
    tp = torch.sum(pred_binary * y_binary)
    fp = torch.sum(pred_binary * (1 - y_binary))
    fn = torch.sum((1 - pred_binary) * y_binary)
    if mesh is not None:
        counts = torch.stack([tp, fp, fn])
        dist.all_reduce(counts)
        tp, fp, fn = counts.unbind()
    precision = tp / (tp + fp + 1e-8)
    recall = tp / (tp + fn + 1e-8)
    return 2 * precision * recall / (precision + recall + 1e-8)


def binary_match_f1(pred: torch.Tensor, y: torch.Tensor, op_type: str = "sum_cp",
                    threshold: float = 0.01, mesh=None) -> torch.Tensor:
    return f1score(_reduce(pred, op_type) > threshold, _reduce(y, op_type) > threshold, mesh)


def pool_mse(pred: torch.Tensor, y: torch.Tensor, kernel_size: int = 2) -> torch.Tensor:
    """MSE of a k x k x k average pool over the (l*c, h, w) volume."""
    win = (kernel_size,) * 3
    p = _avg_pool_nd(_to_bp_lc_hw(pred), win, win, ((0, 0),) * 3)
    g = _avg_pool_nd(_to_bp_lc_hw(y), win, win, ((0, 0),) * 3)
    return torch.mean(torch.square(p - g))


def mean_ratio(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric per-voxel magnitude ratio."""
    ratio = (pred + 0.01) / (y + 0.01)
    return torch.mean(torch.where(ratio < 1, 1 / ratio, ratio))


def accuracy(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Last-axis argmax agreement."""
    return (torch.argmax(pred, -1) == torch.argmax(y, -1)).float().mean()


def l1_metric(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - y))


def build_metric_suite(
    names: Sequence[str] = ("binarymatch", "binarymatchf1", "poolmse", "l1"),
    acc_types: Sequence[str] = ("raw", "sum_c", "sum_cp"),
    f1_types: Sequence[str] = ("raw", "sum_c", "sum_cp"),
    poolmse_kernel_sizes: Sequence[int] = (2, 4),
    mesh=None,
) -> Dict[str, Callable]:
    """{metric name: fn(pred, y)}, the JAX suite's names. Under a
    data-parallel `mesh` the F1 metrics are the global batch's on every
    rank; the others are means, which average exactly over equal blocks."""
    suite: Dict[str, Callable] = {}
    names = [n.lower() for n in names]
    if "acc" in names:
        suite["Acc"] = accuracy
    if "binarymatch" in names:
        for t in acc_types:
            suite[f"BinaryMatch_{t}"] = functools.partial(binary_match, op_type=t)
    if "binarymatchf1" in names:
        for t in f1_types:
            suite[f"BinaryMatchF1_{t}"] = functools.partial(binary_match_f1, op_type=t,
                                                            mesh=mesh)
    if "meanratio" in names:
        suite["MeanRatio"] = mean_ratio
    if "poolmse" in names:
        for k in poolmse_kernel_sizes:
            suite[f"PoolMSE_{k}"] = functools.partial(pool_mse, kernel_size=k)
    if "l1" in names:
        suite["L1"] = l1_metric
    return suite
