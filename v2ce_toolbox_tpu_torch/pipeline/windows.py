"""Sliding-window scheduling and overlap-correct voxel merging.

The reference slices an N-frame video into ceil((N-1)/16) windows of 17
frames (16 consecutive-frame pairs); when (N-1) is not a multiple of 16 the
last window's start index is pulled back so it still spans 16 pairs, and
the merge step deduplicates the overlap by keeping only the last
`(N-1) % 16` frames of the final window (reference: v2ce.py:150-154,
211-239). Here both steps are pure index math over a stacked window axis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def plan_windows(frame_count: int, seq_len: int = 16) -> Tuple[np.ndarray, int]:
    """Compute window start indices and the overlap mode.

    Returns:
      starting_indexes: (S,) int array of first-frame indices; window s
        covers frames [start, start + seq_len] inclusive (seq_len+1 frames).
      mode: (frame_count-1) % seq_len — 0 means the last window is disjoint,
        otherwise only its trailing `mode` pairs are new.
    """
    if frame_count < 2:
        raise ValueError("need at least 2 frames to form one pair")
    sequence_num = int(np.ceil((frame_count - 1) / seq_len))
    mode = (frame_count - 1) % seq_len
    starting_indexes = np.arange(sequence_num) * seq_len
    if mode != 0:
        starting_indexes[-1] -= seq_len - mode
    if starting_indexes[-1] < 0:
        # A video with fewer than seq_len+1 frames cannot fill one window;
        # the reference's arithmetic (v2ce.py:150-154) silently produces a
        # negative start here and reads garbage — fail loudly instead.
        raise ValueError(
            f"frame_count={frame_count} is too short for seq_len={seq_len}: "
            f"need at least {seq_len + 1} frames")
    return starting_indexes, mode


def merge_window_voxels(windows: np.ndarray, mode: int) -> np.ndarray:
    """Stitch per-window voxels (S, L, ...) into a single (T, ...) stream.

    T = (S-1)*L + (mode or L). Matches merge_voxels (v2ce.py:211-239): all
    windows contribute all L frames except the last, which contributes only
    its trailing `mode` frames when mode != 0.

    Works for any trailing layout (H, W, C) or (2, 10, H, W).
    """
    s = windows.shape[0]
    seq_len = windows.shape[1]
    parts = []
    if s > 1:
        parts.append(windows[:-1].reshape((s - 1) * seq_len, *windows.shape[2:]))
    last = windows[-1]
    parts.append(last[-mode:] if mode != 0 else last)
    return np.concatenate(parts, axis=0)
