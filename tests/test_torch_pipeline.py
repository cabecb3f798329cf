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

from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("flag", [
    # both raised until the v2 sampler core was ported: a 10 fps bin now
    # runs end to end (at 1 fps on a narrow model here), and a pano stream
    # of 768x1032 raises the wire record's ValueError instead
    ["--fps", "10"], ["-t", "pano", "--height", "768"]])
def test_cli_uncovered_flags_raise(clip, flag, tmp_path, monkeypatch):
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import ldati

    if flag[0] == "-t":
        # 768 rows break the wire record's 9-bit y (and 1032 columns its
        # 10-bit x): refused before stage 1
        def no_stage1(*args, **kwargs):
            raise AssertionError("stage 1 ran")

        monkeypatch.setattr(V2ce3d, "forward", no_stage1)
        with pytest.raises(ValueError, match="wire record"):
            cli.main(["-i", clip, "-o", str(tmp_path), "--device", "cpu",
                      "-m", str(tmp_path / "absent.pt"), *flag])
        return

    # a low frame rate end to end through the v2 core, on the narrow model
    # (the CLI's full-width model is too slow here): at 1 fps the ids of a
    # 64x160 frame leave the packed key too few bits for a bin's µs
    import cv2

    from tools.make_test_video import make_frames

    w, fps = 160, 1
    assert not ldati.supports_rows(2, H, w, fps=fps)
    path = str(tmp_path / "wide.mp4")
    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, H))
    for f in make_frames(N, H, w):
        video.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    video.release()
    pipe = V2cePipeline(PipelineConfig(height=H, width=w, fps=fps, model=ModelConfig(**SMALL),
                                       write_event_frame_video=False),
                        model_path=None, device="cpu", seed=1)
    with torch.no_grad():
        pipe.model.UNet.pred.conv3d.bias.fill_(0.4)
    counts = {}
    for method in ("run", "run_streaming"):
        result = getattr(pipe, method)(input_video_path=path, out_folder=str(tmp_path / method))
        ev = np.load(result["event_stream_path"])["event_stream"]
        assert ev.dtype == EVENT_DTYPE and result["num_events"] == len(ev) > 0
        assert ev["x"].min() >= 0 and ev["x"].max() < w
        assert ev["y"].min() >= 0 and ev["y"].max() < H
        assert set(np.unique(ev["polarity"])) <= {0, 1}
        assert np.all(np.diff(ev["timestamp"]) >= 0)
        assert 0 <= ev["timestamp"].min() and ev["timestamp"].max() < (N - 1) / fps * 1e6
        counts[method] = len(ev)
    assert counts["run"] == counts["run_streaming"]


@pytest.mark.parametrize("flag,infer_type,method", [
    (["--bf16"], "center", "run"), (["--bf16", "--streaming"], "center", "run_streaming"),
    (["--bf16", "-t", "pano"], "pano", "run")])
def test_cli_bf16_reaches_the_pipeline(clip, flag, infer_type, method, tmp_path, monkeypatch):
    # --bf16 gives the pipeline a bfloat16 stage 1 (v2ce.py:106-107); the
    # pipeline itself is recorded, not run: the full-width model is too
    # slow for the CPU (tests/test_torch_research_bf16.py runs bf16 stage 1)
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.pipeline import driver

    seen = {}

    class Recorder:
        def __init__(self, config, **kwargs):
            seen["config"] = config

        def run(self, **kwargs):
            seen["method"] = "run"
            return {}

        def run_streaming(self, **kwargs):
            seen["method"] = "run_streaming"
            return {}

    monkeypatch.setattr(driver, "V2cePipeline", Recorder)
    cli.main(["-i", clip, "-o", str(tmp_path), "--device", "cpu",
              "-m", str(tmp_path / "absent.pt"), *flag])
    cfg = seen["config"]
    assert cfg.model.compute_dtype == torch.bfloat16 and cfg.model.conv_impl == "xla"
    assert cfg.infer_type == infer_type and seen["method"] == method


@pytest.mark.parametrize("inputs", [[], ["-i", "missing.mp4"], "both"])
def test_cli_rejects_bad_inputs(clip, inputs, tmp_path):
    from v2ce_toolbox_tpu_torch import cli

    if inputs == "both":
        inputs = ["-i", clip, "-f", str(tmp_path)]
    with pytest.raises(SystemExit):
        cli.main(["-o", str(tmp_path), "--device", "cpu", *inputs])
