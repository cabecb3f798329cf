"""v2e-convention intensity mappings (reference:
train/scripts/utils/v2e_utils.py:5-43, train/scripts/utils/physical_att.py:216-247).

A copy of `v2ce_toolbox_tpu/utils/v2e.py` (numpy only).
"""

from __future__ import annotations

import math

import numpy as np


def lin_log(x: np.ndarray, threshold: float = 20) -> np.ndarray:
    """Linear below `threshold`, logarithmic above, with the v2e float64
    rounding convention (reference: v2e_utils.py:5-43)."""
    rounding = 1e8
    f = (1.0 / threshold) * math.log(threshold)
    x = x.astype(np.float64) + 1e-8
    y = np.where(x <= threshold, x * f, np.log(x))
    y = np.round(y * rounding) / rounding
    return y.astype(np.float32)


def gen_log_frame_residual_batch(frames: np.ndarray) -> np.ndarray:
    """(N, H, W) intensity frames -> (N-1, 1, H, W) log-frame residuals
    (reference: physical_att.py:233-247)."""
    ll = lin_log(frames)
    return (ll[1:] - ll[:-1])[:, np.newaxis, ...]
