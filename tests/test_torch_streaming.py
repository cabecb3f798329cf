"""`V2cePipeline.run_streaming` of the port against its `run` on a tiny clip
with a narrow model: each 16-frame window flows through stage 1 and
stage 2 alone, the last one re-emitting only its non-overlapping tail.
Emission counts are a function of the voxels alone, so the event totals
are equal; the draws differ (per window, not per chunk), so timestamps
agree in range only. The CLI's --streaming flag takes this path."""

import os

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline

from tests.torch_budget import cpu_budget

SMALL = dict(base_num_channels=4, num_encoders=2, num_residual_blocks=1)
H, W, N = 48, 64, 21


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread and the worker at a lower priority for a
    module (`tests/torch_budget.py`)."""
    with cpu_budget(1):
        yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import cv2

    from tools.make_test_video import make_frames

    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for f in make_frames(N, H, W):
        video.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    video.release()
    return path


def test_run_streaming_matches_run(clip, tmp_path):
    pipe = V2cePipeline(PipelineConfig(height=H, width=W, model=ModelConfig(**SMALL)),
                        device="cpu", seed=1)
    with torch.no_grad():       # positive voxels, so the clip emits events
        pipe.model.UNet.pred.conv3d.bias.fill_(0.4)
    full = pipe.run(input_video_path=clip, out_folder=str(tmp_path / "run"))
    stream = pipe.run_streaming(input_video_path=clip, out_folder=str(tmp_path / "stream"))
    a = np.load(full["event_stream_path"])["event_stream"]
    b = np.load(stream["event_stream_path"])["event_stream"]
    assert a.dtype == b.dtype == EVENT_DTYPE
    assert stream["num_events"] == full["num_events"] == len(b) > 0
    assert stream["voxels_shape"] == full["voxels_shape"] == (N - 1, H, W, 20)
    assert os.path.getsize(stream["event_frame_video"]) > 0
    assert np.all(np.diff(b["timestamp"]) >= 0)
    assert b["timestamp"].max() < (N - 1) / 30 * 1e6
    for k in ("x", "y", "polarity"):
        np.testing.assert_array_equal(np.bincount(b[k].astype(np.int64)),
                                      np.bincount(a[k].astype(np.int64)))
    assert stream["timings"]["windows"] == 2


def test_cli_streaming_flag(clip, tmp_path):
    from v2ce_toolbox_tpu_torch import cli

    with torch.no_grad():
        result = cli.main(["-i", clip, "-o", str(tmp_path), "--device", "cpu",
                           "-m", str(tmp_path / "absent.pt"), "--width", str(W),
                           "--height", str(H), "--streaming", "--stage2_strategy", "none",
                           "-l", "warning"])
    assert result["event_stream_path"].endswith("-events.npz")
    assert result["timings"]["windows"] == 2
