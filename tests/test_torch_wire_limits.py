"""The wire record's limits. A record holds y in 9 bits and x in 9 or 10
(`_x_bits_for_width`); the JAX driver flattens an event at y >= 512 or
x >= 1024 into a record whose fields overlap, and its decode gives other
coordinates back, without an error. The port flattens such an event to
the same words, so its pipeline refuses those geometries
(`driver.check_wire`) before stage 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.events import EventStream as JaxEventStream
from v2ce_toolbox_tpu.pipeline import driver as jd
from v2ce_toolbox_tpu_torch.events import EventStream
from v2ce_toolbox_tpu_torch.pipeline import driver
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

CAP = 128


def _one_event(x, y, t_us=1234):
    a = dict(t_us=np.full((1, CAP), 2 ** 31 - 1, np.int32), x=np.zeros((1, CAP), np.int16),
             y=np.zeros((1, CAP), np.int16), p=np.zeros((1, CAP), np.int8),
             count=np.ones(1, np.int32), dropped=np.zeros(1, np.int32))
    a["t_us"][0, 0], a["x"][0, 0], a["y"][0, 0], a["p"][0, 0] = t_us, x, y, 1
    return a


@pytest.mark.parametrize("h,w,x,y", [(768, 346, 5, 600), (260, 1032, 1030, 7)],
                         ids=["y600", "x1030"])
def test_jax_wire_record_breaks_past_its_fields(h, w, x, y):
    a = _one_event(x, y)
    x_bits = jd._x_bits_for_width(w)
    offsets = np.zeros(1, np.int32)
    scap = jd._side_cap(1, CAP, int(2e6 / 30) + 2)
    words, kept, side_key, n_side, _ = jd._flatten_chunk_stream(
        JaxEventStream(**{k: jnp.asarray(v) for k, v in a.items()}), jnp.asarray(offsets),
        frames=1, side_cap=scap, x_bits=x_bits)
    n, m = int(kept), int(n_side)
    assert n == 1
    ts, dx, dy, dp = jd._decode_packed_events(np.asarray(words[:, :1]),
                                              np.asarray(side_key[:m]), n, x_bits=x_bits)
    assert (int(dx[0]), int(dy[0])) != (x, y)              # the fault, silent in JAX

    # the port's flatten writes the same words; its pipeline refuses the
    # geometry instead
    got = driver._flatten_chunk_stream(
        EventStream(**{k: torch.from_numpy(v) for k, v in a.items()}),
        torch.from_numpy(offsets), 1, side_cap=scap, x_bits=x_bits)
    assert int(got[1]) == 1
    np.testing.assert_array_equal(got[0][:, :1].numpy().view(np.uint32),
                                  np.asarray(words[:, :1]))
    with pytest.raises(ValueError, match="wire record"):
        driver.check_wire(h, w)


def test_wire_record_holds_its_limits():
    # the largest (y, x) the guard lets through decode back exactly
    a = _one_event(1023, 511)
    rec = driver._flatten_chunk_stream(
        EventStream(**{k: torch.from_numpy(v) for k, v in a.items()}),
        torch.zeros(1, dtype=torch.int32), 1, side_cap=2048, x_bits=10)
    driver.check_wire(512, 1024)
    driver.check_wire(512)                                  # the height alone
    with pytest.raises(ValueError, match="wire record"):
        driver.check_wire(513)
    n, m = int(rec[1]), int(rec[3])
    ts, x, y, p = driver._decode_packed_events(rec[0][:, :1].numpy(), rec[2][:m].numpy(), n,
                                               x_bits=10)
    assert (int(x[0]), int(y[0]), int(p[0]), int(ts[0])) == (1023, 511, 1, 1234)
