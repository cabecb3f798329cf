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
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


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


@pytest.mark.parametrize("bad", [
    # (sampler settings, height, width): the packed key cannot hold the
    # voxel ids; these raised until the v2 sampler core was ported
    (dict(), 260, 1009), (dict(additional_events_strategy="random"), 260, 1024),
    (dict(fps=10), 260, 346), (dict(pooling_type="avg", bidirectional=True), 520, 692)])
def test_uncovered_sampler_modes_raise(bad, monkeypatch):
    # what the v3 core does not cover raises only where the v3 rows are
    # asked for: check_config accepts these, and sample_events hands them
    # to the v2 core (stubbed here: tests/test_torch_ldati_v2.py runs it)
    settings, h, w = bad
    cfg = SamplerConfig(**settings)
    assert not ldati.supports_rows(2, h, w, fps=cfg.fps,
                                   additional_events_strategy=cfg.additional_events_strategy,
                                   pooling_type=cfg.pooling_type)
    ldati.check_config(cfg, 2, 10, h, w)
    seen = []
    monkeypatch.setattr(ldati, "_sample_events_v2",
                        lambda v, draw, c, **kw: seen.append((tuple(v.shape), c, kw)))
    v = torch.zeros((1, 2, 10, h, w))
    with pytest.raises(ValueError, match="v3 sampler core"):
        ldati.sample_events(v, ldati.make_draw(0, 0, "cpu"), cfg, return_rows=True)
    assert seen == []
    ldati.sample_events(v, ldati.make_draw(0, 0, "cpu"), cfg)
    assert seen == [((1, 2, 10, h, w), cfg, dict(t0=0.0, max_multi_voxels=1 << 16))]


@pytest.mark.parametrize("geometry", [(513, 346), (260, 1025)])
def test_wire_record_limits_raise(geometry):
    # y has 9 bits and x at most 10 in the wire record: the pipeline refuses
    # such a stream before it builds the model
    from v2ce_toolbox_tpu_torch.config import PipelineConfig
    from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline

    h, w = geometry
    with pytest.raises(ValueError, match="wire record"):
        V2cePipeline(PipelineConfig(height=h, width=w), device="cpu")


def test_relocate_erase_beginning_matches_jax():
    # tests/test_ldati.py:46: values below 0.001 are zeroed before the ceil
    from v2ce_toolbox_tpu.ops.ldati import relocate_counts

    rng = np.random.RandomState(9)
    y = (rng.rand(2, 10, 6, 7) * 0.02).astype(np.float32)
    assert (y < 0.001).any() and (y >= 0.001).any()
    ref_c, ref_t = relocate_counts(jnp.asarray(y), erase_beginning=True)
    got_c, got_t = ldati.relocate_counts(torch.from_numpy(y), erase_beginning=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    plain_c, _ = ldati.relocate_counts(torch.from_numpy(y))
    assert not torch.equal(plain_c, got_c)
