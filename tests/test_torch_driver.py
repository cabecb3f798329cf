"""Fused wire path of the PyTorch port against the JAX driver.

The port's `_fetch_chunk_events_fused` and the JAX one sample the same
voxels with the same uniform draws (the port's draw provider returns
`jax.random.uniform(fold_in(key, j), shape)`), flatten to the bit-packed
wire format and decode on the host; the decoded streams are compared in
the dense (3-bit delta) and the sparse wire format, with skip_lead.

The decoded streams must be byte-identical: same events, same order, same
timestamps. XLA:CPU contracts some f32 multiply-adds of the JAX sampler
into FMA; the port computes those with `ops.ldati.fma32`.

These JAX calls run the Pallas kernels in interpret mode and compile for
tens of seconds, so they live in this file alone and each runs once.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import SamplerConfig as JaxSamplerConfig
from v2ce_toolbox_tpu.pipeline.driver import (
    _fetch_chunk_events_fused as jax_fetch,
)
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops.bitpack import pack_bits, unpack_bits
from v2ce_toolbox_tpu_torch.pipeline import driver as port_driver
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

F, P, C = 4, 2, 10
CASES = {
    # density, scale, (h, w), skip_lead, caps, expected wire delta bits
    "dense": dict(density=1.0, scale=1.2, hw=(32, 64), skip=0,
                  caps=dict(event_capacity=1 << 16, cap_bin=1 << 12,
                            multi_cap=1024, sort_cap=1 << 12),
                  bits=[3]),
    "sparse_skip": dict(density=0.2, scale=3.0, hw=(24, 36), skip=2,
                        caps=dict(event_capacity=1 << 12, cap_bin=1 << 9,
                                  multi_cap=512, sort_cap=1 << 9),
                        bits=[3, 12]),
}


def _jax_draw(key):
    def draw(j, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, j), shape)))
    return draw


@pytest.fixture(scope="module", params=sorted(CASES))
def streams(request):
    return _streams(request.param)


@functools.cache
def _streams(name):
    """Both sides' wire streams for one case, once a process."""
    case = CASES[name]
    h, w = case["hw"]
    rng = np.random.RandomState(11)
    v = ((rng.rand(F, P, C, h, w) < case["density"])
         * rng.rand(F, P, C, h, w) * case["scale"]).astype(np.float32)
    offsets = (np.arange(F) / 30 * 1e6).astype(np.int32)
    key = jax.random.key(3)
    ref = jax_fetch(jnp.asarray(v), key, jnp.asarray(offsets), F,
                    JaxSamplerConfig(**case["caps"]), 30,
                    skip_lead=case["skip"], width=w)
    with mock.patch.object(port_driver, "_flatten_rows",
                           wraps=port_driver._flatten_rows) as spy:
        got = port_driver._fetch_chunk_events_fused(
            torch.from_numpy(v), _jax_draw(key), torch.from_numpy(offsets), F,
            SamplerConfig(**case["caps"]), 30, skip_lead=case["skip"], width=w)
    bits_used = [c.kwargs["delta_bits"] for c in spy.call_args_list]
    return name, ref, got, bits_used


def test_fused_fetch_matches_jax(streams):
    name, ref, got, bits_used = streams
    assert bits_used == CASES[name]["bits"], bits_used
    assert len(ref) > 0
    assert got.dtype == ref.dtype
    assert got.tobytes() == ref.tobytes()
    if CASES[name]["skip"]:
        assert got["timestamp"].min() >= int(CASES[name]["skip"] / 30 * 1e6)


@pytest.mark.parametrize("b", [22, 31, 32])
def test_pack_bits_round_trip_and_matches_jax(b):
    from v2ce_toolbox_tpu.ops.bitpack import pack_bits as jax_pack_bits

    rng = np.random.RandomState(b)
    n = 32 * 37
    recs = rng.randint(0, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    words = pack_bits(torch.from_numpy(recs), b).numpy().view(np.uint32)
    assert words.shape == (b, n // 32)
    np.testing.assert_array_equal(
        words, np.asarray(jax_pack_bits(jnp.asarray(recs), b)))
    mask = (1 << b) - 1
    np.testing.assert_array_equal(unpack_bits(words, b, n),
                                  recs.astype(np.int64).astype(np.uint32) & np.uint32(mask))
