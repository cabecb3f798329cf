"""Preview images of `train.main` (`--dump_previews`) and the event plots
of `tools/vis_stage2`.

`event_frame_rgb` is `tools/vis_tools.py`'s numpy function; `batch_show`
draws the same grid of titled panels with cv2 in place of matplotlib;
`plot_raw_events_xyt` is its matplotlib x-y-t scatter (`vis_tools.py:71`),
which needs matplotlib.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

CELL = 160          # the longer side of a panel, px
TITLE_H = 18        # the title band above a panel, px


def event_frame_rgb(voxel_frame: np.ndarray, bound: float = 5.0) -> np.ndarray:
    """(2, C, H, W) single-frame voxel -> RGB uint8 preview: ON counts in
    red, OFF in green, each clipped at `bound`."""
    ef = voxel_frame.sum(axis=1)                      # (2, H, W)
    ef = np.clip(ef / bound, 0, 1)
    h, w = ef.shape[1:]
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 0] = (ef[0] * 255).astype(np.uint8)
    rgb[..., 1] = (ef[1] * 255).astype(np.uint8)
    return rgb


def _to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """A gray (H, W) image in [0, 1] (or uint8) or an RGB (H, W, 3) one ->
    RGB uint8."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    return a


def batch_show(images: Sequence[np.ndarray], cols: int = 4,
               titles: Optional[Sequence[str]] = None,
               save_path: Optional[str] = None) -> np.ndarray:
    """A grid of the images, `cols` a row, each scaled to fit a CELL-px
    panel under its title. Returns the RGB uint8 grid and writes it to
    `save_path` (any format cv2 writes) when one is given."""
    import cv2

    n = len(images)
    rows = -(-n // cols)
    grid = np.full((rows * (CELL + TITLE_H), cols * CELL, 3), 255, np.uint8)
    for i, img in enumerate(images):
        a = _to_rgb_u8(img)
        h, w = a.shape[:2]
        s = CELL / max(h, w)
        nh, nw = max(1, round(h * s)), max(1, round(w * s))
        a = cv2.resize(a, (nw, nh), interpolation=cv2.INTER_NEAREST)
        y0, x0 = (i // cols) * (CELL + TITLE_H), (i % cols) * CELL
        grid[y0 + TITLE_H:y0 + TITLE_H + nh, x0:x0 + nw] = a
        if titles is not None and i < len(titles):
            cv2.putText(grid, str(titles[i]), (x0 + 2, y0 + TITLE_H - 5),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1, cv2.LINE_AA)
    if save_path:
        if not cv2.imwrite(save_path, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR)):
            raise OSError(f"cv2 could not write {save_path}")
    return grid


def plot_raw_events_xyt(events: np.ndarray, max_events: int = 50000,
                        save_path: Optional[str] = None):
    """x-y-t scatter of a raw event stream, ON red, OFF blue, of at most
    max_events (a seeded subset, kept in time order); written to
    save_path, or the figure returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(events) > max_events:
        sel = np.random.RandomState(0).choice(len(events), max_events, replace=False)
        events = events[np.sort(sel)]
    fig = plt.figure(figsize=(9, 6))
    ax = fig.add_subplot(projection="3d")
    colors = np.where(events["polarity"] > 0, "r", "b")
    ax.scatter(events["timestamp"], events["x"], events["y"], c=colors, s=1, alpha=0.4)
    ax.set_xlabel("t (µs)")
    ax.set_ylabel("x")
    ax.set_zlabel("y")
    ax.invert_zaxis()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig
