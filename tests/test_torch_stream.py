"""The EventStream route of the port against the JAX driver: `sample_events`
(per-frame buffers through the K3 merge), the unfused flatten
`_fetch_chunk_events` (K5 append, then the wire format) and
`V2cePipeline.voxels_to_events`, given the same voxels and the same
uniform draws; and the host-edge entry `sample_voxel_statistical` with the
recarray helpers. Bidirectional relocation (the mode that takes this route
in the pipeline) on a dense chunk, and 'random' (not time-sorted: the
sparse wire format) on a sparse one with skip_lead. The EventStream
fields and the decoded streams must be byte-identical.
"""

import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu import events as jax_events
from v2ce_toolbox_tpu.config import PipelineConfig as JaxPipelineConfig
from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.ops import ldati as jax_ldati
from v2ce_toolbox_tpu.ops.ldati import sample_events as jax_sample_events
from v2ce_toolbox_tpu_torch import events
from v2ce_toolbox_tpu.pipeline import driver as jax_driver
from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig, SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from v2ce_toolbox_tpu_torch.pipeline import driver

from tests.test_torch_modes import assert_streams_equal, jax_draw
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

F = 4
CASES = {
    "bidirectional_dense": dict(
        density=1.0, scale=1.2, hw=(32, 64), skip=0, bits=[3],
        sampler=dict(bidirectional=True, event_capacity=1 << 16, cap_bin=1 << 12,
                     multi_cap=1024, sort_cap=1 << 12)),
    "random_sparse_skip": dict(
        density=0.2, scale=3.0, hw=(24, 36), skip=2, bits=[3, 12],
        sampler=dict(additional_events_strategy="random", event_capacity=1 << 12,
                     cap_bin=1 << 9, multi_cap=512, sort_cap=1 << 9)),
}


def _voxels(case):
    h, w = case["hw"]
    rng = np.random.RandomState(11)
    return ((rng.rand(F, 2, 10, h, w) < case["density"])
            * rng.rand(F, 2, 10, h, w) * case["scale"]).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def chunk(request):
    return _chunk(request.param)


@functools.cache
def _chunk(name):
    """Both sides' EventStreams for one case, once a process."""
    case = CASES[name]
    v = _voxels(case)
    jcfg = JaxSamplerConfig(**case["sampler"])
    key = jax.random.key(5)
    ckey = jax.random.fold_in(key, 0)          # voxels_to_events' chunk 0
    ref = jax_sample_events(jnp.asarray(v), ckey, **jcfg.sample_kwargs(fps=30))
    cfg = SamplerConfig(**case["sampler"])
    got = ldati.sample_events(torch.from_numpy(v), jax_draw(ckey), cfg)
    return name, case, v, key, jcfg, cfg, ref, got


def test_sample_events_matches_jax(chunk):
    _, _, _, _, _, _, ref, got = chunk
    assert_streams_equal(ref, got)
    assert int(got.count.sum()) > 0


def test_unfused_fetch_matches_jax(chunk):
    name, case, v, _, jcfg, cfg, ref, got = chunk
    w = case["hw"][1]
    offsets = (np.arange(F) / 30 * 1e6).astype(np.int32)
    monotone = cfg.additional_events_strategy != "random"
    kw = dict(skip_lead=case["skip"], base_us=123, width=w, monotone=monotone)
    want = jax_driver._fetch_chunk_events(ref, jnp.asarray(offsets), F, 30, **kw)
    with mock.patch.object(driver, "_flatten_chunk_stream",
                           wraps=driver._flatten_chunk_stream) as spy:
        have = driver._fetch_chunk_events(got, torch.from_numpy(offsets), F, 30, **kw)
    assert [c.kwargs["delta_bits"] for c in spy.call_args_list] == case["bits"]
    assert len(want) > 0 and have.dtype == want.dtype
    assert have.tobytes() == want.tobytes()
    if case["skip"]:
        assert have["timestamp"].min() >= 123 + int(case["skip"] / 30 * 1e6)


def test_voxels_to_events_matches_jax(chunk):
    name, case, v, key, jcfg, cfg, _, _ = chunk
    h, w = case["hw"]
    voxels = v.reshape(F, 20, h, w)
    stub = types.SimpleNamespace(config=JaxPipelineConfig(
        height=h, width=w, stage2_batch_size=F, sampler=jcfg))
    want = jax_driver.V2cePipeline.voxels_to_events(stub, jnp.asarray(voxels), key)
    pipe = driver.V2cePipeline(
        PipelineConfig(height=h, width=w, stage2_batch_size=F, sampler=cfg,
                       model=ModelConfig(base_num_channels=4, num_encoders=2,
                                         num_residual_blocks=1)), device="cpu")
    with mock.patch.object(driver, "make_draw",
                           lambda seed, i, dev: jax_draw(jax.random.fold_in(key, i))):
        have = pipe.voxels_to_events(torch.from_numpy(voxels))
    assert len(have) == len(want) == F
    for a, b in zip(want, have):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sample_voxel_statistical_matches_jax():
    rng = np.random.RandomState(12)
    v = ((rng.rand(2, 2, 10, 8, 24) < 0.4) * rng.rand(2, 2, 10, 8, 24) * 4
         ).astype(np.float32)
    kw = dict(t0=0.5, pooling_type="weighted", max_events_per_voxel=4, capacity=1 << 12)
    want = jax_ldati.sample_voxel_statistical(v, **kw)
    have = ldati.sample_voxel_statistical(v, draw=jax_draw(jax.random.key(0)),
                                          device="cpu", **kw)
    assert len(have) == len(want) == 2 and len(have[0]) > 0
    for a, b in zip(want, have):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (events.concatenate_recarrays(have).tobytes()
            == jax_events.concatenate_recarrays(want).tobytes())
