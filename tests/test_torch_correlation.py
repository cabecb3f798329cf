"""K8's plain twin (`v2ce_toolbox_tpu_torch/ops/correlation.py`) against the
JAX package's cost volume on the same numpy features: the Pallas kernel in
interpret mode (as `tests/test_correlation.py` runs it) within 1e-6 of the
largest |output|, and `correlation_jnp` within 1e-5 (`jnp.mean` divides
where the kernel multiplies by 1/C, and the sums run in other orders).
The port works in NCHW, the JAX package in NHWC. Also: the tap subset
FastFlowNet keeps against JAX's full volume indexed by CORR_INDEX (1e-5),
the decoder input written in place against the gather-and-concatenate
route (identical), and the kernel's launch plan at FastFlowNet's five
levels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops.correlation import correlation as jax_correlation
from v2ce_toolbox_tpu.ops.correlation import correlation_jnp
from v2ce_toolbox_tpu_torch.models.fastflownet import (CORR_INDEX, DECODER_IN, FastFlowNet,
                                                       init_fastflownet)
from v2ce_toolbox_tpu_torch.ops.correlation import (MAX_STAGES, MAX_SMEM, MAX_SUMS,
                                                    MAX_THREADS, MIN_ITEMS, _correlation_torch,
                                                    correlation, plan)
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _features(seed, c, n=2, h=12, w=20):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            rng.randn(n, h, w, c).astype(np.float32))


def _port(f1, f2, md):
    nchw = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in (f1, f2)]
    out = correlation(*nchw, max_displacement=md)             # a CPU tensor: the twin
    return np.moveaxis(out.numpy(), 1, -1)


def _assert_close(got, want, tol):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("md", [2, 3, 4])
@pytest.mark.parametrize("c", [16, 32, 64])
def test_twin_matches_jnp(md, c):
    f1, f2 = _features(md * 100 + c, c)
    want = np.asarray(correlation_jnp(jnp.asarray(f1), jnp.asarray(f2), max_displacement=md))
    _assert_close(_port(f1, f2, md), want, 1e-5)


@pytest.mark.parametrize("md,c", [(2, 16), (3, 32), (4, 64)])
def test_twin_matches_pallas_interpret(md, c):
    f1, f2 = _features(md * 10 + c, c)
    want = np.asarray(jax_correlation(jnp.asarray(f1), jnp.asarray(f2), max_displacement=md,
                                      interpret=True))
    _assert_close(_port(f1, f2, md), want, 1e-6)


def test_twin_edges_are_zero_padded():
    """A tap reaching past the plane reads zeros: with all-ones features
    each output counts the taps inside the plane, / 1."""
    f = torch.ones((1, 4, 5, 7))
    out = _correlation_torch(f, f, max_displacement=4)
    assert out.shape == (1, 81, 5, 7)
    assert float(out[0, 40].min()) == 1.0                      # the centre tap
    assert float(out[0, 0, 0, 0]) == 0.0                       # (-4, -4) from a corner
    assert float(out[0, 0, 4, 4]) == 1.0                       # ... lands at (0, 0)


# FastFlowNet's five levels for 260x346 frames padded to 320x384, 16 pairs
LEVELS = [(16, 32, 80, 96), (16, 64, 40, 48), (16, 64, 20, 24), (16, 64, 10, 12),
          (16, 64, 5, 6)]


@pytest.mark.parametrize("c", [16, 32])
def test_taps_twin_matches_jnp_selection(c):
    """The 53 CORR_INDEX taps, as FastFlowNet keeps them, against JAX's
    full volume indexed by CORR_INDEX."""
    f1, f2 = _features(c + 7, c)
    want = np.asarray(correlation_jnp(jnp.asarray(f1), jnp.asarray(f2),
                                      max_displacement=4))[..., CORR_INDEX]
    nchw = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in (f1, f2)]
    got = correlation(*nchw, max_displacement=4, taps=CORR_INDEX)
    assert got.shape == (2, len(CORR_INDEX), 12, 20)
    _assert_close(np.moveaxis(got.numpy(), 1, -1), want, 1e-5)


@pytest.mark.parametrize("lvl,flow", [(6, False), (5, True), (2, True)])
def test_decoder_input_in_place_equals_concat(lvl, flow):
    """The decoder input written in place (taps into channels 0-52, then
    rconv and the flow) equals the gather-and-concatenate route exactly."""
    torch.manual_seed(lvl)
    net = FastFlowNet()
    init_fastflownet(net, lvl)
    cin = 32 if lvl == 2 else 64
    f1, f2 = torch.randn(2, cin, 6, 10), torch.randn(2, cin, 6, 10)
    flow_up = torch.randn(2, 2, 6, 10) if flow else None
    with torch.no_grad():
        got = net.decoder_input(lvl, f1, f2, flow_up)
        want = torch.cat([_correlation_torch(f1, f2, 4)[:, torch.from_numpy(CORR_INDEX)],
                          getattr(net, f"rconv{lvl}")(f1),
                          torch.zeros(2, 2, 6, 10) if flow_up is None else flow_up], 1)
    assert got.shape == (2, DECODER_IN, 6, 10)
    assert torch.equal(got, want)


def test_out_view_leaves_neighbouring_channels():
    f1, f2 = torch.randn(3, 8, 5, 7), torch.randn(3, 8, 5, 7)
    buf = torch.full((3, 12, 5, 7), -7.0)
    taps = [40, 0, 80, 13]
    got = correlation(f1, f2, 4, taps=taps, out=buf[:, 3:7])
    assert got.data_ptr() == buf[:, 3:7].data_ptr()
    assert torch.equal(buf[:, 3:7], _correlation_torch(f1, f2, 4)[:, taps])
    assert bool((buf[:, :3] == -7).all()) and bool((buf[:, 7:] == -7).all())
    with pytest.raises(ValueError, match="distinct"):
        correlation(f1, f2, 4, taps=[1, 1])
    with pytest.raises(ValueError, match="out must be"):
        correlation(f1, f2, 4, taps=taps, out=buf[:, :3])


@pytest.mark.parametrize("md", [1, 2, 3, 4])
def test_plan_fits_the_card_at_every_level(md):
    """The kernel's tiling of FastFlowNet's levels (and of ragged and tiny
    maps) stays within a block's shared memory and thread limits, keeps at
    most MAX_SUMS f32 sums a thread, covers the image with whole dy rows,
    and at FastFlowNet's md 4 gives every TMA level at least MIN_ITEMS work
    items."""
    d = 2 * md + 1
    for n, c, h, w in LEVELS + [(16, 16, 37, 45), (2, 16, 12, 20), (1, 3, 1, 1)]:
        pl = plan(n, c, h, w, md)
        assert pl["smem_bytes"] <= MAX_SMEM and pl["smem_bytes"] <= 227 * 1024
        assert pl["sums"] == d * pl["p"] <= MAX_SUMS
        assert pl["threads"] == pl["tx"] // pl["p"] * pl["ty"] * pl["dyb"] <= MAX_THREADS
        assert d % pl["dyb"] == 0 and pl["tx"] % pl["p"] == 0
        assert 1 <= pl["stages"] <= MAX_STAGES and 1 <= pl["cs"] <= min(c, 256)
        vw = 4 if pl["p"] % 4 == 0 else 2
        assert pl["r1"] >= pl["tx"] and pl["r2"] >= pl["tx"] - pl["p"] + -(-(pl["p"] + 2 * md)
                                                                         // vw) * vw
        assert pl["r1"] % 8 == 4 and pl["r2"] % 8 == 4
        assert pl["tma"] == (w % 4 == 0) and (pl["tma"] or pl["stages"] == 1)
        if (n, c, h, w) in LEVELS and md == 4 and pl["tma"]:    # FastFlowNet's md
            assert pl["items"] >= MIN_ITEMS
