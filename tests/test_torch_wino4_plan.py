"""K12's fused bf16 kernel (`csrc/wino4.cu`, `v2ce_conv3d_wino4_bf16`) from
the CPU: what its wrapper hands it and the order it sums in.

  * U in the conv core's (36, 3, Co, C) layout, `conv3d_wino4.gemm_weights`,
    is the JAX package's `filter_transform_lh` permuted, bit for bit, in
    f32 and after the cast to bf16.
  * The tile plan (`conv3d_wino4.fused_plan`) fits a block of sm_90: shared
    memory under 227 KB, the consumers' f32 registers under their
    setmaxnreg of 232 (and 255), for the probe's three `wino_pallas` input
    widths and every Co from 8 to 768.
  * The kernel's summation order, emulated here in plain torch: per plane,
    each step (one BK-channel slice) sums its products over the three W
    taps and the slice from zero, the step sums add up to z in f32, and z
    is collapsed through AT in the JAX kernel's order (the twin adds the W
    taps after the collapses instead). Held against the JAX kernel in
    interpret mode within `WINO_REL_TOL` = 1e-5 of its largest output, in
    f32 and with bf16 inputs (transforms rounded to bf16 as both round
    them), at a shape with two K steps, ragged L, H and W, and Co not a
    multiple of 8."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from v2ce_toolbox_tpu.ops import winograd_pallas as jax_wino
from v2ce_toolbox_tpu_torch.ops import conv3d_wino4
from v2ce_toolbox_tpu_torch.tools.perf_probe import WINO_SHAPES
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

WINO_REL_TOL = 1e-5


@pytest.mark.parametrize("c,co", [(16, 8), (12, 5), (40, 12)])
def test_gemm_weights_are_the_jax_filter_transform(c, co):
    k = (np.random.RandomState(c * co).rand(3, 3, 3, c, co) * 0.05).astype(np.float32)
    for jdt, tdt in [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]:
        uj = jax_wino.filter_transform_lh(jnp.asarray(k).astype(jdt)).astype(jdt)
        uj = np.asarray(uj.astype(jnp.float32)).reshape(36, c, 3, co).transpose(0, 2, 3, 1)
        ut = conv3d_wino4.gemm_weights(torch.from_numpy(k).to(tdt), tdt)
        assert ut.dtype == tdt and tuple(ut.shape) == (36, 3, co, c)
        assert np.array_equal(ut.float().numpy(), uj)


@pytest.mark.parametrize("name,c", [(name, shape[-1]) for name, shape, _ in WINO_SHAPES])
def test_fused_plan_fits_a_block(name, c):
    for co in list(range(8, 769, 8)) + [co for n, _, co in WINO_SHAPES if n == name]:
        plan = conv3d_wino4.fused_plan(c, co)
        assert plan["rows"] == 64 and plan["bn"] == 32 and plan["bk"] in (32, 64)
        assert plan["nk"] * plan["bk"] >= c and plan["n_tiles"] * plan["bn"] >= co
        assert 2 <= plan["stages"] <= conv3d_wino4.FUSED_MAX_STAGES
        assert plan["smem_bytes"] <= conv3d_wino4.SMEM_LIMIT, (co, plan)
        assert plan["registers"] == plan["register_sets"] * plan["bn"] // 2
        assert plan["registers"] < conv3d_wino4.CONSUMER_REGISTERS <= 255, (co, plan)
    # the K step: a 128-byte swizzled row where C is a multiple of 64
    assert conv3d_wino4.fused_plan(c, 32)["bk"] == (64 if c % 64 == 0 else 32)


def _dw_first(x, k, bk):
    """The fused kernel's sums in plain torch: x (B, L, H, W, C) and k in
    f32 or bf16, f32 out."""
    b, l, h, w, c = x.shape
    co = k.shape[4]
    cdt = x.dtype
    nl, nh = -(-l // 4), -(-h // 4)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 4 * nh + 1 - h, 1, 4 * nl + 1 - l))
    u = conv3d_wino4.gemm_weights(k, cdt).float()          # (36, 3, Co, C)
    nk = -(-c // bk)
    e_terms = [xp[:, :, s:s + 4 * nh:4] for s in range(6)]
    y = [[None] * 4 for _ in range(4)]
    for lam in range(6):
        e = conv3d_wino4._lincomb(e_terms, conv3d_wino4.BT4[lam], cdt)
        v_terms = [e[:, r:r + 4 * nl:4] for r in range(6)]
        p = [None] * 4
        for xi in range(6):
            v = conv3d_wino4._lincomb(v_terms, conv3d_wino4.BT4[xi], cdt)  # (b, nl, nh, w+2, c)
            z = None
            for kk in range(nk):
                sl = slice(kk * bk, (kk + 1) * bk)
                step = sum(v[..., dw:dw + w, sl] @ u[6 * xi + lam, dw, :, sl].T
                           for dw in range(3))
                z = step if z is None else z + step
            for a in range(4):
                p[a] = conv3d_wino4._accumulate(p[a], z, conv3d_wino4.AT4[a, xi])
        for a in range(4):
            for bh in range(4):
                y[a][bh] = conv3d_wino4._accumulate(y[a][bh], p[a], conv3d_wino4.AT4[bh, lam])
    out = torch.stack([torch.stack(y[a], 3) for a in range(4)], 2)   # (b, nl, 4, nh, 4, w, co)
    return out.reshape(b, 4 * nl, 4 * nh, w, co)[:, :l, :h]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_first_order_matches_jax(dtype):
    shape, co = (1, 5, 9, 10, 40), 12
    rng = np.random.RandomState(7)
    x = (rng.rand(*shape) - 0.5).astype(np.float32)
    k = (rng.rand(3, 3, 3, shape[-1], co) * 0.05).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_wino.conv3d_wino4(jnp.asarray(x).astype(jdt),
                                            jnp.asarray(k).astype(jdt), lt=4, th=4))
    plan = conv3d_wino4.fused_plan(shape[-1], co)
    assert plan["nk"] == 2                              # two K steps, the second ragged
    got = _dw_first(torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt), plan["bk"])
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= WINO_REL_TOL
