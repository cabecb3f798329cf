"""A 600 px wide stream (a two-strip pano width): the 10-bit x field of the
wire format, on both of the port's stage-2 routes, against the JAX
EventStream route with the same voxels and draws.

The JAX side runs `sample_events(use_gen_compact=False)`: above 128 px the
TPU gen_compact kernel orders a row's candidates by its tiling, so the
deferred draws land on other voxels; gen_pack + compact_rows keeps the
canonical order that the port's K1 twin has. The port's fused route
(K1 twin, the wire format built on the rows) and its unfused route (K4
twin when asked, the EventStream, the K5 flatten) must both decode to the
JAX stream byte for byte.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.ops.ldati import sample_events as jax_sample_events
from v2ce_toolbox_tpu.pipeline import driver as jax_driver
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from v2ce_toolbox_tpu_torch.pipeline import driver

from tests.test_torch_modes import assert_streams_equal, jax_draw
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

F, H, W = 2, 4, 600
CAPS = dict(event_capacity=1 << 13, cap_bin=1 << 11, multi_cap=512, sort_cap=1 << 11)


def test_wide_stream_routes_match_jax():
    rng = np.random.RandomState(3)
    v = ((rng.rand(F, 2, 10, H, W) < 0.3) * rng.rand(F, 2, 10, H, W) * 4
         ).astype(np.float32)
    offsets = (np.arange(F) / 30 * 1e6).astype(np.int32)
    key = jax.random.key(9)
    jcfg = JaxSamplerConfig(**CAPS, use_gen_compact=False)
    ref = jax_sample_events(jnp.asarray(v), key, **jcfg.sample_kwargs(fps=30))
    want = jax_driver._fetch_chunk_events(ref, jnp.asarray(offsets), F, 30, width=W)
    assert len(want) > 0 and want["x"].max() >= 512

    cfg = SamplerConfig(**CAPS)
    vt, ot = torch.from_numpy(v), torch.from_numpy(offsets)
    fused = driver._fetch_chunk_events_fused(vt, jax_draw(key), ot, F, cfg, 30, width=W)
    assert fused.tobytes() == want.tobytes()
    for use_gen_compact in (True, False):
        got = ldati.sample_events(vt, jax_draw(key),
                                  dataclasses.replace(cfg, use_gen_compact=use_gen_compact))
        assert_streams_equal(ref, got)
    unfused = driver._fetch_chunk_events(got, ot, F, 30, width=W)
    assert unfused.tobytes() == want.tobytes()
