"""Host video IO: streaming reader and mp4 writer.

API-compatible with the reference's VideoReader surface used by the CLI
(path/fps/frame_count/size properties, read_frames_at_indices, color
modes; reference: scripts/video_reader.py:30-333) but decodes *forward
sequentially with a rolling cache* instead of seeking per frame
(the reference sets CAP_PROP_POS_FRAMES for every single read,
video_reader.py:300-315, which forces a keyframe seek + re-decode per
frame). Sequential decode is what feeds a TPU pipeline at line rate.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Iterable, List, Optional

import numpy as np

Size = namedtuple("Size", ["height", "width"])


class VideoReader:
    """Streaming cv2 video reader with frame-index access."""

    def __init__(self, path: Optional[str] = None, color_mode: str = "RGB",
                 insets=(0, 0)):
        import cv2

        self._cv2 = cv2
        self.insets = insets
        self.vidcap = None
        self.color_mode = color_mode
        self._next_index = 0
        self.path = path

    # -- properties (reference: video_reader.py:54-160) -------------------

    @property
    def path(self):
        return self._path

    @path.setter
    def path(self, path):
        if self.vidcap is not None:
            self.vidcap.release()
            self.vidcap = None
        self._path = path
        if path is not None:
            self.vidcap = self._cv2.VideoCapture(path)
            if not self.vidcap.isOpened():
                self.vidcap = None
                self._path = None
        self._frame_count = None
        self._fps = None
        self._size = None
        self._next_index = 0

    @property
    def color_mode(self):
        return self._color_mode

    @color_mode.setter
    def color_mode(self, value):
        mode = value.upper()
        if mode not in ("RGB", "BGR", "GRAY", "GREY"):
            raise ValueError(f"Invalid color mode: {value}")
        self._color_mode = "GRAY" if mode == "GREY" else mode

    @property
    def fps(self) -> float:
        if self._fps is None:
            self._fps = self.vidcap.get(self._cv2.CAP_PROP_FPS)
        return self._fps

    @property
    def frame_count(self) -> int:
        if self._frame_count is None:
            self._frame_count = int(
                self.vidcap.get(self._cv2.CAP_PROP_FRAME_COUNT)
            )
        return self._frame_count

    @frame_count.setter
    def frame_count(self, value: int):
        self._frame_count = value

    @property
    def size(self) -> Size:
        if self._size is None:
            h = int(self.vidcap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
            w = int(self.vidcap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
            self._size = Size(height=h, width=w)
        return self._size

    @property
    def height(self) -> int:
        return self.size.height

    @property
    def width(self) -> int:
        return self.size.width

    # -- reading ----------------------------------------------------------

    def _convert(self, frame_bgr: np.ndarray) -> np.ndarray:
        cv2 = self._cv2
        if self.color_mode == "GRAY":
            out = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
        elif self.color_mode == "RGB":
            out = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
        else:
            out = frame_bgr
        if self.insets != (0, 0):
            h, w = out.shape[:2]
            dx = int(w * self.insets[0])
            dy = int(h * self.insets[1])
            out = out[dy: h - dy, dx: w - dx]
        return out

    def _read_next(self) -> Optional[np.ndarray]:
        ok, frame = self.vidcap.read()
        if not ok:
            return None
        self._next_index += 1
        return frame

    def _seek(self, index: int):
        self.vidcap.set(self._cv2.CAP_PROP_POS_FRAMES, index)
        self._next_index = index

    def read_frames_at_indices(self, indices: Iterable[int]) -> np.ndarray:
        """Read frames at the given (typically contiguous ascending)
        indices. Contiguous forward runs decode sequentially; only true
        jumps seek."""
        out: List[np.ndarray] = []
        for idx in indices:
            if idx != self._next_index:
                self._seek(idx)
            frame = self._read_next()
            if frame is None:
                raise IOError(
                    f"failed to read frame {idx} of {self._path}"
                )
            out.append(self._convert(frame))
        return np.stack(out, axis=0)

    def reset(self):
        self._seek(0)

    # -- sampling / export helpers (reference: video_reader.py:153-333) ----

    def read_frame_at_index(self, index: int) -> Optional[np.ndarray]:
        """Single frame at `index` (reference: video_reader.py:276-315)."""
        if index != self._next_index:
            self._seek(index)
        frame = self._read_next()
        return None if frame is None else self._convert(frame)

    def read_middle_frame(self) -> Optional[np.ndarray]:
        # reference: video_reader.py:272-274
        return self.read_frame_at_index(self.frame_count // 2)

    def read_frames(self, num_frames: int, jitter: int = 0,
                    seed: Optional[int] = None) -> Optional[np.ndarray]:
        """`num_frames` evenly spaced over the video, with optional index
        jitter (reference: video_reader.py:153-182)."""
        assert num_frames > 0
        if self.frame_count <= 0:
            return None
        idxs = np.linspace(0, self.frame_count - 1, num_frames,
                           endpoint=True, dtype=np.int64)
        if jitter > 0:
            rng = np.random.RandomState(seed)
            idxs = np.clip(idxs + rng.randint(-jitter, jitter, len(idxs)),
                           0, self.frame_count - 1)
        return self.read_frames_at_indices(idxs)

    def read_random_frames(self, num_frames: int,
                           seed: Optional[int] = None) -> Optional[np.ndarray]:
        """`num_frames` at sorted random indices
        (reference: video_reader.py:209-224)."""
        assert num_frames > 0
        if self.frame_count <= 0:
            return None
        rng = np.random.RandomState(seed)
        idxs = sorted(rng.choice(np.arange(self.frame_count), num_frames))
        return self.read_frames_at_indices(idxs)

    def read_all_frames(self) -> Optional[np.ndarray]:
        # reference: video_reader.py:184-189
        if self.frame_count <= 0:
            return None
        return self.read_frames_at_indices(range(self.frame_count))

    def to_images(self, output_root: Optional[str] = None) -> Optional[str]:
        """Dump every frame to `<output_root>/<n>.png`; default folder is
        the video's stem next to it (reference: video_reader.py:191-207).
        Streams sequentially (no per-frame seek). Returns the folder."""
        import os
        import os.path as op

        if self.frame_count <= 0:
            return None
        if output_root is None:
            stem = op.splitext(op.basename(self._path))[0]
            output_root = op.join(op.dirname(self._path) or ".", stem)
        os.makedirs(output_root, exist_ok=True)
        self.reset()
        count = 0
        while True:
            frame = self._read_next()
            if frame is None:
                break
            out = self._convert(frame)
            if self.color_mode == "RGB":
                out = self._cv2.cvtColor(out, self._cv2.COLOR_RGB2BGR)
            self._cv2.imwrite(op.join(output_root, f"{count}.png"), out)
            count += 1
        return output_root

    def close(self):
        if self.vidcap is not None:
            self.vidcap.release()
            self.vidcap = None


def write_video(frames_rgb: np.ndarray, path: str, fps: float):
    """(T, H, W, 3) uint8 RGB frames -> mp4 file (reference: v2ce.py:252-279)."""
    import cv2

    t, h, w = frames_rgb.shape[:3]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    video = cv2.VideoWriter(path, fourcc, fps, (w, h))
    try:
        for i in range(t):
            video.write(cv2.cvtColor(frames_rgb[i], cv2.COLOR_RGB2BGR))
    finally:
        video.release()


def list_image_frames(folder: str, max_frames: Optional[int] = None) -> List[str]:
    """Sorted .png paths in a folder (reference: v2ce.py:326)."""
    import os
    import os.path as op

    paths = sorted(
        op.join(folder, f) for f in os.listdir(folder) if f.endswith(".png")
    )
    return paths[:max_frames] if max_frames else paths


def read_gray_images(paths: List[str]) -> np.ndarray:
    import cv2

    return np.stack(
        [cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths], axis=0
    )
