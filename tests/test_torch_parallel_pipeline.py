"""`V2cePipeline` over data-parallel gloo ranks (`parallel/mesh.py`),
spawned CPU processes that import no JAX (`tests/torch_parallel_ranks.py`),
on a 21-frame 32x44 clip with a narrow model: 10 two-frame windows in
stage-1 batches of 3 and 5 stage-2 chunks of 4 frames, so the last group
of each is uneven over 2 and 3 ranks.

  * stage 1 (`video_to_voxels`) on 2 ranks against the JAX pipeline's on a
    2-device mesh (`tests/test_pipeline.py::test_multichip_inference_sharding`'s
    shape and tolerance, rtol 2e-4, atol 2e-5), and bit for bit against
    one rank's, on every rank;
  * `run` and `run_streaming` on 2 and 3 ranks against one rank: the npz
    stream byte for byte and the preview video's bytes; rank 0 alone
    writes.

Every world rendezvouses under the test's temporary directory, with a
collective timeout of 60 s and a wall limit of 120 s."""

import functools
import os
import tempfile
from unittest import mock

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as ranks
from tests.test_torch_streaming import one_torch_thread  # noqa: F401
from tests.torch_research import fill_variables
from tools.make_test_video import make_frames
from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.config import PipelineConfig as JaxPipelineConfig
from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.io.video import VideoReader as JaxVideoReader
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.parallel.mesh import make_mesh
from v2ce_toolbox_tpu.pipeline import driver as jdriver
from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig, SamplerConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.parallel import mesh as pmesh
from v2ce_toolbox_tpu_torch.utils.weights import from_jax_variables

H, W, FRAMES = 32, 44, 21
TINY = dict(base_num_channels=4, num_encoders=2)
SETTINGS = dict(height=H, width=W, batch_size=3, seq_len=2, max_frame_num=FRAMES,
                stage2_batch_size=4)
CAPACITY = 1 << 12
WALL_S, COLLECTIVE_S = 120, 60


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for f in make_frames(num_frames=FRAMES, height=H, width=W):
        video.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    video.release()
    return path


@pytest.fixture(scope="module")
def jax_run(clip):
    """The JAX pipeline's stage 1 on a 2-device mesh, and its weights (the
    prediction bias raised so the clip emits events) as the port's."""
    cfg = JaxPipelineConfig(model=JaxModelConfig(**TINY),
                            sampler=JaxSamplerConfig(event_capacity=CAPACITY), **SETTINGS)
    model = JaxV2ce3d(config=cfg.model)
    # drawn with numpy (an eager flax init costs ~30 s)
    variables = fill_variables(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, 2, H, W, 2)), train=False), 0)
    variables["params"]["unet"]["pred"]["conv"]["bias"][:] = 0.4
    with mock.patch.object(jdriver, "load_variables", lambda *a, **k: variables):
        pipe = jdriver.V2cePipeline(cfg, model_path=None, mesh=make_mesh(2))
    vidcap = JaxVideoReader(clip, color_mode="GRAY")
    try:
        vox = np.asarray(pipe.video_to_voxels(vidcap=vidcap))
    finally:
        vidcap.close()
    return vox, from_jax_variables(variables, num_encoders=2)


@pytest.fixture(scope="module")
def world(clip, jax_run, tmp_path_factory):
    """n -> each rank's results over a world of n ranks (1: this process,
    without a mesh), each world writing under its own folder."""
    cfg = PipelineConfig(model=ModelConfig(**TINY), sampler=SamplerConfig(event_capacity=CAPACITY),
                         **SETTINGS)
    sd = jax_run[1]
    root = tmp_path_factory.mktemp("worlds")

    @functools.cache
    def of(n):
        out = str(root / f"n{n}")
        if n == 1:
            return [ranks.pipeline_rank(None, cfg, sd, clip, out)]
        with mock.patch.object(tempfile, "tempdir", str(root)):     # the rendezvous
            return pmesh.launch(ranks.pipeline_rank, n, args=(cfg, sd, clip, out),
                                devices=["cpu"] * n, timeout_s=WALL_S,
                                collective_timeout_s=COLLECTIVE_S)

    return of


def test_two_ranks_stage1_matches_the_jax_mesh(world, jax_run):
    one, two = world(1)[0]["voxels"], world(2)
    assert one.shape == jax_run[0].shape == (FRAMES - 1, 20, H, W)
    np.testing.assert_allclose(two[0]["voxels"], jax_run[0], rtol=2e-4, atol=2e-5)
    for r in two:                        # every rank holds every window, bit for bit
        assert r["voxels"].tobytes() == one.tobytes()


def test_runs_over_ranks_are_byte_identical(world):
    one = world(1)[0]
    for n in (2, 3):
        many = world(n)
        for mode in ("run", "streaming"):
            want, got = one[mode], many[0][mode]
            a = np.load(want["event_stream_path"])["event_stream"]
            b = np.load(got["event_stream_path"])["event_stream"]
            assert a.dtype == b.dtype == EVENT_DTYPE and len(a) > 0
            assert b.tobytes() == a.tobytes(), (n, mode)
            assert got["num_events"] == want["num_events"]
            with open(want["event_frame_video"], "rb") as f, \
                    open(got["event_frame_video"], "rb") as g:
                assert f.read() == g.read(), (n, mode)
            # the other ranks wrote nothing; the one folder holds rank 0's files
            assert all("event_stream_path" not in r[mode] for r in many[1:])
            assert sorted(os.listdir(os.path.dirname(got["event_stream_path"]))) == sorted(
                os.path.basename(p) for p in (got["event_stream_path"],
                                              got["event_frame_video"]))
