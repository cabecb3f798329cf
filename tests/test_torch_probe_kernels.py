"""K13-K16 and K7 of the port against the JAX package, on the CPU, where
the wrappers run their plain twins: the stage-2 roofline probes
(`ops/roofline`) against `pallas_call`s built here from the bodies of
`tools/perf_probe.py:2510-2636` (closures inside `probe_stage2_roofline`,
so they cannot be imported), with `interpret=True`, and `layout_barrier`
(`ops/barrier`) against `v2ce_toolbox_tpu/ops/barrier.layout_barrier`.
All integer or copies: identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from v2ce_toolbox_tpu.ops.barrier import layout_barrier as jax_layout_barrier
from v2ce_toolbox_tpu_torch.ops import barrier, roofline

R, N_CHUNKS, SC, LANES = 2, 3, 8, 128


def _x(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 30, (R, N_CHUNKS, SC, LANES)).astype(np.int32)


def _op_kernel(k):
    # perf_probe.py:2510 make_op_kernel
    def kern(x_ref, o_ref):
        ci = pl.program_id(1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (SC, LANES), 1)
        x = x_ref[0, 0]
        for _ in range(k // 4):
            x = pltpu.roll(x, 1, axis=1)
            x = x ^ lane
            x = pltpu.roll(x, 1, axis=0)
            x = jnp.where(lane < 64, x, x + 1)

        @pl.when(ci == N_CHUNKS - 1)
        def _():
            o_ref[0] = x
    return kern


def _ilp_kernel(k):
    # perf_probe.py:2554 make_ilp_kernel
    def kern(x_ref, o_ref):
        ci = pl.program_id(1)
        lane = jax.lax.broadcasted_iota(jnp.int32, (SC, LANES), 1)
        xs = [x_ref[0, 0] + i for i in range(4)]
        for _ in range(k // 16):
            xs = [pltpu.roll(x, 1, axis=1) for x in xs]
            xs = [x ^ lane for x in xs]
            xs = [pltpu.roll(x, 1, axis=0) for x in xs]
            xs = [jnp.where(lane < 64, x, x + 1) for x in xs]

        @pl.when(ci == N_CHUNKS - 1)
        def _():
            o_ref[0] = xs[0] ^ xs[1] ^ xs[2] ^ xs[3]
    return kern


def _chain_call(kernel, x):
    # perf_probe.py:2529 / :2573
    return pl.pallas_call(
        kernel,
        grid=(R, N_CHUNKS),
        in_specs=[pl.BlockSpec((1, 1, SC, LANES), lambda ri, ci: (ri, ci, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, SC, LANES), lambda ri, ci: (ri, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, SC, LANES), jnp.int32),
        interpret=True,
    )(jnp.asarray(x))


def _copy_call(row_blocks, x):
    # perf_probe.py:2597 copy_kern / :2626 copy_row_kern
    if row_blocks:
        def kern(x_ref, o_ref):
            o_ref[0] = x_ref[0]
        grid, block = (R,), (1, N_CHUNKS, SC, LANES)
        index = lambda ri: (ri, 0, 0, 0)  # noqa: E731
    else:
        def kern(x_ref, o_ref):
            o_ref[0, 0] = x_ref[0, 0]
        grid, block = (R, N_CHUNKS), (1, 1, SC, LANES)
        index = lambda ri, ci: (ri, ci, 0, 0)  # noqa: E731
    return pl.pallas_call(
        kern, grid=grid,
        in_specs=[pl.BlockSpec(block, index, memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(block, index, memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((R, N_CHUNKS, SC, LANES), jnp.int32),
        interpret=True,
    )(jnp.asarray(x))


@pytest.mark.parametrize("k", [8, 16])
def test_op_chain_twin_matches_pallas(k):
    x = _x(k)
    want = np.asarray(_chain_call(_op_kernel(k), x))
    np.testing.assert_array_equal(roofline.op_chain(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("k", [8, 16, 32])
def test_op_chain_ilp_twin_matches_pallas(k):
    x = _x(k + 1)
    want = np.asarray(_chain_call(_ilp_kernel(k), x))
    np.testing.assert_array_equal(roofline.op_chain_ilp(torch.from_numpy(x), k).numpy(), want)


@pytest.mark.parametrize("row_blocks", [False, True], ids=["chunk", "row"])
def test_stream_copies_match_pallas(row_blocks):
    x = _x(2)
    want = np.asarray(_copy_call(row_blocks, x))
    copy = roofline.stream_copy_row if row_blocks else roofline.stream_copy
    got = copy(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("shape,dtype", [((1, 4, 6, 10, 5), "float32"), ((7,), "float32"),
                                         ((3, 5, 6), "bfloat16")])
def test_layout_barrier_matches_jax(shape, dtype):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = np.asarray(jax_layout_barrier(jnp.asarray(x).astype(getattr(jnp, dtype)))
                      .astype(jnp.float32))
    got = barrier.layout_barrier(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tuple(got.shape) == shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_off_cpu_never_takes_the_twin():
    x = torch.empty((R, N_CHUNKS, SC, LANES), dtype=torch.int32, device="meta")
    for fn in (lambda t: roofline.op_chain(t, 8), lambda t: roofline.op_chain_ilp(t, 16),
               roofline.stream_copy, roofline.stream_copy_row, barrier.layout_barrier):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x)
