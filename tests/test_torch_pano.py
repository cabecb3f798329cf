"""Pano mode of the port: the strips folded into the batch axis, the last
one right-aligned and trimmed to the remainder. `make_forward_fn` against
the JAX one with a narrow model on three strips (rtol 1e-4 / atol 1e-5:
the two frameworks sum the conv products in other orders), and the
pipeline run on a clip wider than the model."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.pipeline.infer import make_forward_fn as jax_make_forward_fn
from v2ce_toolbox_tpu.utils.torch_compat import (
    convert_v2ce3d_state_dict,
    state_dict_to_numpy,
)
from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline
from v2ce_toolbox_tpu_torch.pipeline.infer import make_forward_fn
from v2ce_toolbox_tpu_torch.utils.weights import init_weights

from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(base_num_channels=4, num_encoders=2, num_residual_blocks=1)


def test_pano_forward_matches_jax():
    model = V2ce3d(ModelConfig(**SMALL))
    init_weights(model, seed=2)
    model.eval()
    variables = convert_v2ce3d_state_dict(state_dict_to_numpy(model.state_dict()),
                                          num_encoders=2, num_residual_blocks=1)
    frames = np.random.RandomState(4).rand(1, 4, 20, 64).astype(np.float32)
    width = 26                            # strips 0-25, 26-51, 38-63 -> last 12
    ref = jax_make_forward_fn(JaxV2ce3d(config=JaxModelConfig(**SMALL)), variables,
                              infer_type="pano", width=width, resized_width=64)(
        jnp.asarray(frames))
    got = make_forward_fn(model, infer_type="pano", width=width, resized_width=64)(
        torch.from_numpy(frames))
    assert got.shape == (1, 3, 20, 64, 20) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert float(got.abs().max()) > 0


def test_pano_forward_needs_the_resized_width():
    with pytest.raises(ValueError, match="resized_width"):
        make_forward_fn(torch.nn.Identity(), infer_type="pano", width=26)


def test_pano_run_covers_the_full_width(tmp_path):
    import cv2

    from tools.make_test_video import make_frames

    h, w, n = 48, 80, 18
    clip = str(tmp_path / "wide.mp4")
    video = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for f in make_frames(n, h, w):
        video.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    video.release()
    pipe = V2cePipeline(PipelineConfig(infer_type="pano", height=h, width=32,
                                       model=ModelConfig(**SMALL)), device="cpu", seed=3)
    with torch.no_grad():       # positive voxels, so the clip emits events
        pipe.model.UNet.pred.conv3d.bias.fill_(0.4)
    result = pipe.run(input_video_path=clip, out_folder=str(tmp_path / "out"))
    ev = np.load(result["event_stream_path"])["event_stream"]
    assert result["voxels_shape"] == (n - 1, h, w, 20)
    assert ev.dtype == EVENT_DTYPE and len(ev) == result["num_events"] > 0
    assert ev["x"].min() == 0 and ev["x"].max() == w - 1 and ev["y"].max() < h
    assert np.all(np.diff(ev["timestamp"]) >= 0)
