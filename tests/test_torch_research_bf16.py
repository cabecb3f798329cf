"""bf16 stage 1 of the port: the research configuration and the product
`--bf16` configuration against the JAX model with the same configuration
and weights, on the CPU. Tolerance: the JAX package's own bf16 bound
(`tests/test_model_rewrites.py:110-113`), max error <= 0.05 * scale + 1e-3
with scale the largest output: the frameworks round to bf16 at the same
points but sum in other orders, and cuDNN / the CPU conv return bf16 where
XLA returns f32 (models/layers._apply_conv). The research configuration
also runs end to end through V2cePipeline on a tiny clip."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_research as tr
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline


@pytest.fixture(scope="module")
def inputs():
    return tr.narrow_variables(), tr.narrow_input()


def _assert_bf16_close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert scale > 0 and err <= 0.05 * scale + 1e-3, (err, scale)


def test_research_model_matches_jax(inputs):
    variables, x = inputs
    want, jax_k9, jax_k10 = tr.jax_forward(variables, x, jnp.bfloat16)
    got, k9, k10 = tr.port_forward(tr.port_model(variables, torch.bfloat16), x)
    _assert_bf16_close(got, want)
    assert k9 == jax_k9 and len(k9) == 5
    assert k10 == jax_k10 and len(k10) == 2


def test_product_bf16_matches_jax(inputs):
    variables, x = inputs
    want, jax_k9, jax_k10 = tr.jax_forward(variables, x, jnp.bfloat16, research=False)
    got, k9, k10 = tr.port_forward(tr.port_model(variables, torch.bfloat16, research=False), x)
    _assert_bf16_close(got, want)
    f32, _, _ = tr.port_forward(tr.port_model(variables, torch.float32, research=False), x)
    assert float(np.abs(got - f32).max()) > 0      # the compute dtype applied
    assert not (k9 or k10 or jax_k9 or jax_k10)


def test_research_pipeline_runs(tmp_path):
    import cv2

    from tools.make_test_video import make_frames

    h, w, n = 36, 52, 18
    clip = str(tmp_path / "clip.mp4")
    video = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for f in make_frames(n, h, w):
        video.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    video.release()
    model = ModelConfig(**tr.NARROW, **tr.RESEARCH, compute_dtype=torch.bfloat16)
    pipe = V2cePipeline(PipelineConfig(height=h, width=w, model=model), device="cpu", seed=2)
    result = pipe.run(input_video_path=clip, out_folder=str(tmp_path))
    ev = np.load(result["event_stream_path"])["event_stream"]
    assert ev.dtype == EVENT_DTYPE and result["num_events"] == len(ev) > 0
    assert result["voxels_shape"] == (n - 1, h, w, 20)
    assert os.path.getsize(result["event_frame_video"]) > 0
