"""The port's center-mode pipeline end to end on the CPU, at a small size:
an 18-frame 64x86 clip through `V2cePipeline.run` with a narrow model.
Stage-1 voxels match the JAX pipeline's within rtol 1e-4 / atol 1e-5
given the same weights; the npz holds EVENT_DTYPE records inside the
frame, time-sorted."""

import os

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.io.video import VideoReader
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline

SMALL = dict(base_num_channels=4, num_encoders=2, num_residual_blocks=1)
H, W, N = 64, 86, 18


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


@pytest.fixture(scope="module")
def pipeline():
    cfg = PipelineConfig(height=H, width=W, model=ModelConfig(**SMALL))
    pipe = V2cePipeline(cfg, model_path=None, device="cpu", seed=1)
    with torch.no_grad():       # positive voxels, so the clip emits events
        pipe.model.UNet.pred.conv3d.bias.fill_(0.4)
    return pipe


def test_voxels_match_jax(clip, pipeline):
    from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
    from v2ce_toolbox_tpu.config import PipelineConfig as JaxPipelineConfig
    from v2ce_toolbox_tpu.io.video import VideoReader as JaxVideoReader
    from v2ce_toolbox_tpu.pipeline.driver import V2cePipeline as JaxPipeline
    from v2ce_toolbox_tpu.utils.torch_compat import (
        convert_v2ce3d_state_dict,
        state_dict_to_numpy,
    )

    jp = JaxPipeline(JaxPipelineConfig(height=H, width=W, model=JaxModelConfig(**SMALL)))
    jp.variables = convert_v2ce3d_state_dict(
        state_dict_to_numpy(pipeline.model.state_dict()), num_encoders=2,
        num_residual_blocks=1)
    ref = np.asarray(jp.video_to_voxels(vidcap=JaxVideoReader(clip, color_mode="GRAY")))
    got = pipeline.video_to_voxels(vidcap=VideoReader(clip, color_mode="GRAY"))
    assert got.shape == (N - 1, 20, H, W) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_run_writes_event_stream(clip, pipeline, tmp_path):
    result = pipeline.run(input_video_path=clip, out_folder=str(tmp_path))
    ev = np.load(result["event_stream_path"])["event_stream"]
    assert ev.dtype == EVENT_DTYPE
    assert result["num_events"] == len(ev) > 0
    assert ev["x"].min() >= 0 and ev["x"].max() < W
    assert ev["y"].min() >= 0 and ev["y"].max() < H
    assert set(np.unique(ev["polarity"])) <= {0, 1}
    assert np.all(np.diff(ev["timestamp"]) >= 0)
    assert 0 <= ev["timestamp"].min() and ev["timestamp"].max() < (N - 1) / 30 * 1e6
    assert os.path.getsize(result["event_frame_video"]) > 0
    assert result["voxels_shape"] == (N - 1, H, W, 20)
    t = result["timings"]
    assert t["windows"] == 2 and t["chunks"] == 1


@pytest.mark.parametrize("flag", [["--streaming"], ["--bf16"], ["-t", "pano"],
                                  ["--stage2_strategy", "random"],
                                  ["--stage2_pooling", "avg"]])
def test_cli_uncovered_flags_raise(clip, flag, tmp_path):
    from v2ce_toolbox_tpu_torch import cli

    with pytest.raises(NotImplementedError):
        cli.main(["-i", clip, "-o", str(tmp_path), "--device", "cpu",
                  "-m", str(tmp_path / "absent.pt"), *flag])


@pytest.mark.parametrize("inputs", [[], ["-i", "missing.mp4"], "both"])
def test_cli_rejects_bad_inputs(clip, inputs, tmp_path):
    from v2ce_toolbox_tpu_torch import cli

    if inputs == "both":
        inputs = ["-i", clip, "-f", str(tmp_path)]
    with pytest.raises(SystemExit):
        cli.main(["-o", str(tmp_path), "--device", "cpu", *inputs])
