"""The port's LDATI rows against JAX `sample_events(..., return_rows=True)`,
given the same voxels and the same uniform draws (the provider returns
`jax.random.uniform(fold_in(key, j), shape)`, j = 0 for the deferred
slot-0 draw and j for tier j). Rows, voxel ids, emit and drop totals must
be byte-identical.

XLA:CPU contracts some f32 multiply-adds of the JAX sampler into FMA (the
chain timestamp, the density intercept and the inverse-CDF discriminant);
the port computes those with `ldati.fma32`, a single-rounding FMA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.ldati import sample_events
from v2ce_toolbox_tpu_torch.config import SamplerConfig
from v2ce_toolbox_tpu_torch.ops import ldati
from v2ce_toolbox_tpu_torch.ops.compact import INVALID


def test_sample_rows_matches_jax():
    rng = np.random.RandomState(0)
    v = ((rng.rand(2, 2, 10, 16, 24) < 0.3) * rng.rand(2, 2, 10, 16, 24) * 5
         ).astype(np.float32)
    cfg = SamplerConfig(cap_bin=1 << 9, multi_cap=512, sort_cap=1 << 9,
                        event_capacity=1 << 12)
    key = jax.random.key(3)
    ref = sample_events(jnp.asarray(v), key, fps=30, additional_events_strategy="slope",
                        max_events_per_voxel=cfg.max_events_per_voxel,
                        capacity=cfg.event_capacity, cap_bin=cfg.cap_bin,
                        multi_cap=cfg.multi_cap, sort_cap=cfg.sort_cap,
                        return_rows=True)

    def draw(j, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, j), shape)))

    got = ldati.sample_rows(torch.from_numpy(v), draw, cfg)
    for name, a, b in zip(("rel", "vox", "emit", "drop"), ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    rel = got[0]
    assert int((rel != INVALID).sum()) > 0


def test_fma32_rounds_once():
    # a*b = 2^-24 + 2^-60 exactly: the f64 sum 1 + 2^-24 is an f32 midpoint
    # that ties to even; the exact sum rounds up
    a = torch.tensor([np.float32(1 + 2 ** -12)])
    b = torch.tensor([np.float32((1 - 2 ** -12 + 2 ** -24) * 2 ** -24)])
    one = torch.ones(1)
    assert ldati.fma32(a, b, one).item() == 1 + 2 ** -23
    assert ldati.fma32(-a, b, one).item() == 1 - 2 ** -24
    rng = np.random.RandomState(5)
    x, y, z = (torch.from_numpy(rng.randn(4096).astype(np.float32)) for _ in range(3))
    exact = x.double() * y.double() + z.double()
    assert torch.all((ldati.fma32(x, y, z).double() - exact).abs()
                     <= torch.abs(exact.float().double() - exact))


def test_production_draws_repeat_per_chunk_and_slot():
    a = ldati.make_draw(7, 3, "cpu")
    b = ldati.make_draw(7, 3, "cpu")
    assert torch.equal(a(5, (4, 64)), b(5, (4, 64)))
    assert not torch.equal(a(5, (4, 64)), a(6, (4, 64)))
    assert not torch.equal(a(5, (4, 64)), ldati.make_draw(7, 4, "cpu")(5, (4, 64)))
    u = a(0, (1000,))
    assert u.dtype == torch.float32 and float(u.min()) >= 0 and float(u.max()) < 1


@pytest.mark.parametrize("bad", [dict(additional_events_strategy="random"),
                                 dict(pooling_type="avg"), dict(bidirectional=True),
                                 dict(max_events_per_voxel=1)])
def test_uncovered_sampler_modes_raise(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ldati.check_config(SamplerConfig(**bad), 2, 10, 16, 24)
