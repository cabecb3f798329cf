#!/usr/bin/env python
"""Probe harness of the port: the 41 portable probes of the JAX package's
`tools/perf_probe.py`, at their shapes and with their print lines, on one
card.

    python -m v2ce_toolbox_tpu_torch.tools.perf_probe [probe ...] [--device cuda]

Probes (all when none is named), under their JAX names: compact,
compact_algo (K2w, K2), quad, quad_s2 (K11), wino_pallas, wino_ablate
(K12), window_lb (V2ce3d, K7 and the sampler on a 16-frame 260x346
window), stage2_roofline (K13-K16, K2 at the chain-compaction shape,
torch.sort at (144, 16384), K4 gen_pack); the stage-2 splits of
`probes_stage2` (sampler, sort, sampler_phases, gen, flatten,
sampler_strategies, gen_compact, fused_pipeline, fused_phases,
bf16_fidelity, roofline) and the stage-1 splits of `probes_stage1`
(model, model_pad, model_bf16, model_bf16_pad, conv_iso, pallas_conv,
model_pallas_bf16, model_pallas, model_subpixel, pallas_model, fused_dec,
batch_scaling, model_overhead, and the rewrites' wpack, conv2d_decomp, d2,
model_d2, model_knockout, boundary, model_variants, subpixel_variants,
winograd). The `devices:` line states the TF32 settings every f32 number
ran under.

`timed_loop` is the median of warm CUDA-event timings of calls whose
outputs are all reduced into a checksum that is fetched and must be finite
(the JAX harness chained its calls in one jit instead). Where a call's
kernels take less time than its Python takes to launch them (the
compactor, the roofline's kernels), the call is captured once in a CUDA
graph and the graph's replays are timed: the device's time, as the JAX
harness's in-jit loop measured. Each probe takes its
shapes as keywords, with the JAX probe's as defaults, so that a test can
run it small; with `--device cpu` it times on the host clock and runs the
plain twins, and its numbers are the CPU's. A probe that fails prints
`FAILED` where the JAX probe does. Every probe returns its measurements.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.tools import probes_stage1, probes_stage2

N_ITERS = 10


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def timed_loop(fn, args, n_iters: int = N_ITERS, graph: bool = False) -> float:
    """Seconds per call of fn(args): the median of n_iters warm calls, each
    timed by CUDA events on the card (the host clock on the CPU); every
    output leaf is summed into a checksum that is fetched at the end. With
    `graph` (on the card), one call is captured in a CUDA graph and its
    replays are timed, which leaves the launching Python out."""
    dev = next(t for t in _leaves(args)).device
    cuda = dev.type == "cuda"
    check = torch.zeros((), dtype=torch.float64, device=dev)

    def call():
        for leaf in _leaves(fn(args)):
            check.add_(leaf.double().sum())

    call()                                             # warm
    if cuda and graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            call()
        g.replay()
        step = g.replay
    else:
        step = call
    times = []
    for _ in range(n_iters):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
    if not np.isfinite(float(check)):
        raise AssertionError("timed_loop: the checksum of the outputs is not finite")
    return statistics.median(times)


def _failed(label: str, e: Exception, n: int = 200) -> None:
    print(f"{label}: FAILED {type(e).__name__}: {str(e)[:n]}", flush=True)


def _rand_keys(rng, r, n, density):
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID

    return np.where(rng.rand(r, n) < density, rng.randint(0, 1 << 30, (r, n)),
                    INVALID).astype(np.int32)


def probe_compact(dev, r=144, n=2048 * 89, densities=(0.1, 0.3), chunks=(8192, 16384)):
    """The compactor (compact_rows, the default algo 'window': K2w) at the
    sampler's scale: 144 rows (16 frames x 9 bins) x 182,272 slots, 105 MB
    of keys, more than the card's L2 holds. The rows are not a multiple of
    either chunk; K2w takes them unpadded (the JAX wrapper pads), so the
    chunk changes only the kept width, cap rounded up to it."""
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows

    rng = np.random.RandomState(0)
    res = {}
    for density in densities:
        keys = _rand_keys(rng, r, n, density)
        kj = torch.from_numpy(keys).to(dev)
        # correctness spot check (2 rows)
        out, _, kept, _ = compact_rows(kj, cap=1 << 16, chunk=2048)
        out_h, kept_h = out[:2].cpu().numpy(), kept[:2].cpu().numpy()
        for i in range(2):
            valid = keys[i][keys[i] != INVALID][:int(kept_h[i])]
            assert (out_h[i][:len(valid)] == valid).all(), f"row {i} mismatch"
        for ch in chunks:
            def fn(args, ch=ch):
                kk, = args
                o, _, k, t = compact_rows(kk, cap=1 << 16, chunk=ch)
                return o[:, ::127].long().sum(), k.sum(), t.sum()

            try:
                dt = timed_loop(fn, (kj,), graph=True)
                res[(density, ch)] = dt
                print(f"compact d={density} chunk={ch}: {dt*1e3:.2f} ms "
                      f"({r*n/dt/1e9:.2f} Gelem/s)", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"compact d={density} chunk={ch}", e)
    return res


def probe_compact_algo(dev, r=144, n=2048 * 89, chunks=(8192, 16384)):
    """window (K2w) vs place (K2) at the sampler's chain-compaction shape,
    with the slope payload riding along: one contract and one kernel
    (csrc/compact_rows.cu), one block a tile of 8,192 keys for K2w and of
    4,096 for K2."""
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows

    rng = np.random.RandomState(0)
    keys = _rand_keys(rng, r, n, 0.1)
    pays = np.where(keys != INVALID, rng.randint(1, 1 << 20, (r, n)), 0).astype(np.int32)
    kj, pj = torch.from_numpy(keys).to(dev), torch.from_numpy(pays).to(dev)
    res = {}
    for algo in ("window", "place"):
        for ch in chunks:
            def fn(args, ch=ch, algo=algo):
                kk, pp = args
                o, (op,), k, t = compact_rows(kk, [pp], cap=1 << 14, chunk=ch, algo=algo)
                return o[:, ::127].long().sum() + (op[:, ::127] % 31).sum(), k.sum(), t.sum()

            try:
                dt = timed_loop(fn, (kj, pj), graph=True)
                res[(algo, ch)] = dt
                print(f"compact[{algo}] chunk={ch} +payload: {dt*1e3:.2f} ms "
                      f"({r*n/dt/1e9:.2f} Gelem/s)", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"compact[{algo}] chunk={ch}", e, 150)
    return res


QUAD_LAYERS = [
    ("enc1_c2", 130, 173, 64, 64),
    ("enc2_c2", 65, 87, 128, 128),
    ("enc3_c2", 33, 44, 256, 256),
    ("enc4_c2", 17, 22, 512, 512),
    ("botl_c", 17, 22, 512, 512),
    ("dec0_c1", 33, 44, 768, 256),
    ("dec0_c2", 33, 44, 256, 256),
    ("dec1_c1", 65, 87, 384, 128),
    ("dec1_c2", 65, 87, 128, 128),
    ("dec2_c1", 130, 173, 192, 64),
    ("dec2_c2", 130, 173, 64, 64),
    ("dec3_c1", 260, 346, 96, 32),
    ("dec3_c2", 260, 346, 32, 32),
]
QUAD_S2_LAYERS = [
    ("enc1_c1s2", 260, 346, 32, 64),
    ("enc2_c1s2", 130, 173, 64, 128),
    ("enc3_c1s2", 65, 87, 128, 256),
    ("enc4_c1s2", 33, 44, 256, 512),
]
DTYPES = [("bf16", torch.bfloat16), ("f32", torch.float32)]


def _conv_inputs(rng, dev, l, h, w, cin, cout, dt, scale=0.01):
    x = torch.from_numpy(rng.rand(1, l, h, w, cin).astype(np.float32)).to(dev, dt)
    k = torch.from_numpy(rng.rand(3, 3, 3, cin, cout).astype(np.float32) * scale).to(dev, dt)
    return x, k


def probe_quad(dev, layers=QUAD_LAYERS, frames=16):
    """conv3d_quad (K11) on the model's stride-1 3x3x3 layers."""
    from v2ce_toolbox_tpu_torch.ops.conv3d_quad import conv3d_quad

    res = {}
    for name, h, w, cin, cout in layers:
        rng = np.random.RandomState(0)
        flops = 2 * frames * h * w * cin * cout * 27
        for dt_name, dt in DTYPES:
            x, k = _conv_inputs(rng, dev, frames, h, w, cin, cout, dt)
            try:
                t = timed_loop(lambda a: conv3d_quad(*a), (x, k))
                res[(name, dt_name)] = t
                print(f"quad {name} {dt_name}: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"quad {name} {dt_name}", e)
            del x, k
    return res


def probe_quad_s2(dev, layers=QUAD_S2_LAYERS, frames=16):
    """conv3d_quad_s122 (K11 on the phase-folded strided conv) on the
    encoder downsampling layers."""
    from v2ce_toolbox_tpu_torch.ops.conv3d_quad import conv3d_quad_s122

    res = {}
    for name, h, w, cin, cout in layers:
        rng = np.random.RandomState(0)
        ho, wo = -(-h // 2), -(-w // 2)
        flops = 2 * frames * ho * wo * cin * cout * 27
        x, k = _conv_inputs(rng, dev, frames, h, w, cin, cout, torch.bfloat16)
        try:
            t = timed_loop(lambda a: conv3d_quad_s122(*a), (x, k))
            res[(name, "bf16")] = t
            print(f"quad_s2 {name} bf16: {t*1e3:.2f} ms  {flops/t/1e12:.1f} TF/s", flush=True)
        except Exception as e:  # noqa: BLE001
            _failed(f"quad_s2 {name} bf16", e, 150)
        del x, k
    return res


WINO_SHAPES = [
    ("dec3_conv1", (1, 16, 260, 346, 96), 32),
    ("dec2_conv1", (1, 16, 130, 173, 192), 64),
    ("dec3_conv2", (1, 16, 260, 346, 32), 32),
]


def _direct(x, k):
    """The direct conv in f32 out (cuDNN on the card; TF32 as the caller
    set it), as the JAX probe's `lax.conv_general_dilated` with f32
    accumulation."""
    import torch.nn.functional as F

    y = F.conv3d(x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1).float()


def probe_wino_pallas(dev, shapes=WINO_SHAPES,
                      blocks=((8, 8), (4, 8), (8, 4), (4, 4))):
    """conv3d_wino4 (K12) vs the direct conv (cuDNN) on the fill-bound
    model layers, over the JAX probe's block configs."""
    from v2ce_toolbox_tpu_torch.ops.conv3d_wino4 import conv3d_wino4

    res = {}
    for name, xshape, cout in shapes:
        cin = xshape[-1]
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.rand(*xshape).astype(np.float32) - 0.5).to(dev)
        k = torch.from_numpy(rng.rand(3, 3, 3, cin, cout).astype(np.float32) * 0.05).to(dev)
        xb, kb = x.bfloat16(), k.bfloat16()
        flops_direct = 2 * int(np.prod(xshape[:4])) * cin * cout * 27

        # correctness spot check before timing: the bf16 Winograd against
        # the direct conv of the same bf16 values in f32
        ref = _direct(xb.float(), kb.float())
        got = conv3d_wino4(xb, kb)
        rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
        res[(name, "rel_err_bf16")] = rel
        print(f"{name} wino-vs-direct bf16 rel err: {rel:.2e}", flush=True)
        del ref, got

        for dlabel, xx, kk in [("bf16", xb, kb), ("f32", x, k)]:
            dt = timed_loop(lambda a: _direct(*a), (xx, kk))
            res[(name, "direct", dlabel)] = dt
            print(f"{name} direct_{dlabel}: {dt*1e3:.2f} ms  "
                  f"{flops_direct/dt/1e12:.1f} TF/s", flush=True)
            for lt, th in blocks:
                if xshape[1] % lt or lt < 4 or th < 4:
                    continue
                try:
                    dt = timed_loop(lambda a, lt=lt, th=th: conv3d_wino4(*a, lt=lt, th=th),
                                    (xx, kk))
                    res[(name, dlabel, lt, th)] = dt
                    print(f"{name} wino4_{dlabel}[lt={lt},th={th}]: {dt*1e3:.2f} ms  "
                          f"{flops_direct/dt/1e12:.1f} TF/s-equiv", flush=True)
                except Exception as e:  # noqa: BLE001
                    _failed(f"{name} wino4_{dlabel}[lt={lt},th={th}]", e)
        del x, k, xb, kb
    return res


def probe_wino_ablate(dev, shape=(1, 16, 260, 346, 96), cout=32):
    """Stage-cost attribution for the Winograd kernel: full vs noinv (which
    raises, as the JAX kernel's does) vs nodot (z faked from V). On the card
    'nodot' runs the three-launch route (input transform, Z written and read
    in f32, output transform) in both dtypes, while bf16 'full' runs the
    fused kernel, which keeps Z on chip: bf16 'nodot' against 'full' times
    that route against the fused one, not the products alone."""
    from v2ce_toolbox_tpu_torch.ops.conv3d_wino4 import conv3d_wino4

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32) - 0.5).to(dev)
    k = torch.from_numpy(rng.rand(3, 3, 3, shape[-1], cout).astype(np.float32) * 0.05).to(dev)
    res = {}
    for dlabel, xx, kk in [("bf16", x.bfloat16(), k.bfloat16()), ("f32", x, k)]:
        for mode in ("full", "noinv", "nodot"):
            try:
                dt = timed_loop(lambda a, mode=mode: conv3d_wino4(*a, lt=8, th=8, ablate=mode),
                                (xx, kk))
                res[(dlabel, mode)] = dt
                print(f"wino4 dec3_conv1 {dlabel} [{mode}]: {dt*1e3:.2f} ms", flush=True)
            except Exception as e:  # noqa: BLE001
                res[(dlabel, mode)] = None
                _failed(f"wino4 {dlabel} [{mode}]", e, 160)
    return res


def probe_window_lb(dev, seq_len=16, h=260, w=346):
    """One window step with the identity kernel (K7) between the model and
    the sampler, as the JAX probe's fused jit: V2ce3d (full width, seeded
    random weights) on 16 frame pairs, layout_barrier, then the LDATI
    sampler to an EventStream."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.ops.barrier import layout_barrier
    from v2ce_toolbox_tpu_torch.pipeline.preprocess import normalize_pairs
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    scfg = SamplerConfig()
    model = V2ce3d(ModelConfig())
    init_weights(model, 0)
    model.to(dev).eval()
    rng = np.random.RandomState(0)
    frames0 = torch.from_numpy(rng.rand(1, seq_len + 1, h, w).astype(np.float32)).to(dev)
    draw = ldati.make_draw(0, 0, dev)

    def fn(args):
        frames, = args
        with torch.no_grad():
            voxels = model(normalize_pairs(frames))
        voxels = layout_barrier(voxels)
        v = voxels[0].permute(0, 3, 1, 2).reshape(seq_len, 2, 10, h, w).contiguous()
        s = ldati.sample_events(v, draw, scfg)
        return s.count.sum() + (s.t_us.long() % 97).sum() + s.x.long().sum()

    dt = timed_loop(fn, (frames0,))
    print(f"window step (fused, layout barrier): {dt*1e3:.2f} ms ({seq_len/dt:.1f} fps)",
          flush=True)
    return {"window_s": dt}


def int32_issue_rate(dev) -> float | None:
    """The card's issue ceiling for one-lane integer ops, in ops/s: SMs x 4
    schedulers x 32 lanes a clock at the top SM clock nvidia-smi reports
    (one warp instruction a scheduler a clock; the ALU pipe, which takes
    LOP3, and the FMA pipe, which takes IMAD, each issue half of it). None
    off the card."""
    if torch.device(dev).type != "cuda":
        return None
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(dev).multi_processor_count * 128 * mhz * 1e6


def _data_rates(name, el_rate, t_hi, k_hi, total_el, issue):
    """The op chains' ops that touch data (k/2 an element, an XOR and an add
    a round and chain, as `bound_ms` counts them; the JAX probe's el-ops
    count k), from the slope between the two k and at k_hi alone, beside
    their share of the card's issue rate."""
    data_slope, data_hi = el_rate / 2, k_hi // 2 * total_el / t_hi
    share = ("issue rate not measured off the card" if issue is None else
             f"{data_slope / issue:.1%} and {data_hi / issue:.1%} of the int32 issue rate "
             f"{issue / 1e12:.2f} T/s")
    print(f"  {name}: data ops (k/2 an element) {data_slope / 1e12:.2f} T/s from the slope, "
          f"{data_hi / 1e12:.2f} T/s at k={k_hi}; {share}", flush=True)
    return data_slope, data_hi


def probe_stage2_roofline(dev, r=144, chunk=16384, seg=2 * 260 * 346, ks=(64, 256),
                          gen_shape=(16, 2, 10, 260, 346)):
    """Stage-2 roofline on the card: the vector-op ceiling (K13 serial
    chain, K14 4 independent chains) and the stream-copy ceiling (K15 in
    64 KB blocks, K16 in row blocks) at the chain compaction's grid, then
    the chain compaction (K2, place), the final per-bin sort (torch.sort)
    and the generation kernel (K4 gen_pack) against bounds from those
    measured rates."""
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows
    from v2ce_toolbox_tpu_torch.ops.gen import gen_pack
    from v2ce_toolbox_tpu_torch.ops.roofline import (LANES, op_chain, op_chain_ilp, stream_copy,
                                                     stream_copy_row)

    sc = chunk // LANES
    n_chunks = -(-seg // chunk)                       # 11: the padded segment
    n = n_chunks * chunk
    total_el = r * n
    k_lo, k_hi = ks
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 1 << 30, (r, n_chunks, sc, LANES))
                         .astype(np.int32)).to(dev)
    res = {}

    def reduce_tile(out):
        return ((out[:, ::17] % 97).sum(),)

    # 1. vector-op ceiling: the slope between two k isolates the per-op cost
    t_lo = timed_loop(lambda a: reduce_tile(op_chain(a[0], k_lo)), (x,), graph=True)
    t_hi = timed_loop(lambda a: reduce_tile(op_chain(a[0], k_hi)), (x,), graph=True)
    op_rate = (k_hi - k_lo) * total_el / (t_hi - t_lo)
    print(f"synthetic vector-op kernel (serial chain): k={k_lo} {t_lo*1e3:.2f} ms, "
          f"k={k_hi} {t_hi*1e3:.2f} ms -> sustained {op_rate/1e12:.2f} T el-ops/s",
          flush=True)
    issue = int32_issue_rate(dev)
    op_data, op_data_hi = _data_rates("serial chain", op_rate, t_hi, k_hi, total_el, issue)
    res.update(op_t=(t_lo, t_hi), op_rate=op_rate, op_data_rate=op_data,
               op_data_rate_hi=op_data_hi, issue_rate=issue)

    # 1b. ILP ceiling: 4 independent chains interleaved
    ti_lo = timed_loop(lambda a: reduce_tile(op_chain_ilp(a[0], k_lo)), (x,), graph=True)
    ti_hi = timed_loop(lambda a: reduce_tile(op_chain_ilp(a[0], k_hi)), (x,), graph=True)
    ilp_rate = (k_hi - k_lo) * total_el / (ti_hi - ti_lo)
    print(f"synthetic vector-op kernel (4 indep chains): k={k_lo} {ti_lo*1e3:.2f} ms, "
          f"k={k_hi} {ti_hi*1e3:.2f} ms -> sustained {ilp_rate/1e12:.2f} T el-ops/s "
          f"({ilp_rate/op_rate:.2f}x serial)", flush=True)
    ilp_data, ilp_data_hi = _data_rates("4 chains", ilp_rate, ti_hi, k_hi, total_el, issue)
    res.update(ilp_t=(ti_lo, ti_hi), ilp_rate=ilp_rate, ilp_data_rate=ilp_data,
               ilp_data_rate_hi=ilp_data_hi)

    # 2. HBM stream ceiling (read + write), chunk blocks then row blocks
    def reduce_copy(out):
        return ((out[:, :, ::17, 0] % 97).sum(),)

    t_copy = timed_loop(lambda a: reduce_copy(stream_copy(a[0])), (x,), graph=True)
    stream_rate = 2 * total_el * 4 / t_copy
    print(f"stream copy ({chunk * 4 // 1024} KB blocks, {r * n_chunks} blocks): "
          f"{t_copy*1e3:.2f} ms -> {stream_rate/1e9:.0f} GB/s (read+write)", flush=True)
    t_row = timed_loop(lambda a: reduce_copy(stream_copy_row(a[0])), (x,), graph=True)
    row_rate = 2 * total_el * 4 / t_row
    block_fixed_us = max(t_copy - t_row, 0.0) / (r * n_chunks - r) * 1e6
    res.update(copy_t=t_copy, stream_rate=stream_rate, row_t=t_row, row_rate=row_rate)
    # the two copies are two designs (K15 a register copy in small blocks,
    # K16 a ring of bulk copies a row), so the difference is not one
    # design's cost per grid step, as on the TPU
    print(f"stream copy ({n * 4 // 1024} KB blocks, {r} blocks, bulk-copy ring): "
          f"{t_row*1e3:.2f} ms -> {row_rate/1e9:.0f} GB/s; implied fixed cost "
          f"~{block_fixed_us:.2f} us per block (two designs compared, not one design at two "
          f"block sizes)", flush=True)
    rate = max(stream_rate, row_rate)

    # 3. chain compaction at the sampler's shape, with its payload: bound by
    # the bytes it needs (every key, the kept payloads, the outputs) at the
    # measured stream rate
    keys_np = _rand_keys(rng, r, n, 0.1)
    pays_np = np.where(keys_np != INVALID, rng.randint(1, 1 << 20, (r, n)), 0).astype(np.int32)
    keys, pays = torch.from_numpy(keys_np).to(dev), torch.from_numpy(pays_np).to(dev)

    def fn_compact(args):
        kk, pp = args
        o, (op,), k, t = compact_rows(kk, [pp], cap=1 << 14, chunk=chunk, algo="place")
        return o[:, ::127].long().sum() + (op[:, ::127] % 31).sum(), k.sum(), t.sum()

    t_comp = timed_loop(fn_compact, (keys, pays), graph=True)
    comp_rate = total_el / t_comp
    _, _, kept, _ = compact_rows(keys, [pays], cap=1 << 14, chunk=chunk, algo="place")
    cap_pad = -(-(1 << 14) // chunk) * chunk
    comp_bytes = 4 * (total_el + int(kept.sum()) + 2 * r * cap_pad + 2 * r)
    bound_s = comp_bytes / rate
    res.update(compact_t=t_comp, compact_bound=bound_s)
    print(f"chain compaction (place, +payload): {t_comp*1e3:.2f} ms "
          f"({comp_rate/1e9:.2f} Gelem/s); {comp_bytes/1e6:.1f} MB at the measured stream "
          f"rate -> byte bound {bound_s*1e3:.2f} ms -> {bound_s/t_comp*100:.0f}% of bound",
          flush=True)

    # 4. the final per-bin sort at its shape, and the radix alternative
    # priced with the measured compactor rate
    sort_in = torch.from_numpy(_rand_keys(rng, r, 1 << 14, 0.6)).to(dev)
    t_sort = timed_loop(lambda a: ((torch.sort(a[0], dim=1).values[:, ::127] % 97).sum(),),
                        (sort_in,), graph=True)
    sort_el = r * (1 << 14)
    bits = 13                     # sub-bin rel-us at fps=30, cb=9: <= 3704
    radix_s = 2 * bits * sort_el / comp_rate
    res.update(sort_t=t_sort)
    print(f"final sort ({r}, {1 << 14}): {t_sort*1e3:.2f} ms ({sort_el/t_sort/1e9:.2f} "
          f"Gelem/s); radix-on-compactor alternative = 2x{bits} stable partition passes = "
          f"{radix_s*1e3:.1f} ms ({radix_s/t_sort:.1f}x SLOWER)", flush=True)

    # 5. the generation kernel against its stream and op bounds
    f, p, c, h, w = gen_shape
    v = torch.from_numpy((rng.rand(*gen_shape) < 0.1).astype(np.float32)
                         * rng.rand(*gen_shape).astype(np.float32) * 4).to(dev)
    vox_bits = ldati.vox_bits_of(p, h, w)

    def fn_gen(args):
        kg, kxg, emit, drop = gen_pack(args[0], fps=30, t0=0.0, strategy="slope", mepv=32,
                                       vox_bits=vox_bits)
        return (kg[:, ::37] % 97).sum(), (kxg[:, ::37] % 31).sum(), emit.sum(), drop.sum()

    t_gen = timed_loop(fn_gen, (v,), graph=True)
    gen_el = f * (c - 1) * p * h * w
    gen_bytes = (f * p * c * h * w + 2 * gen_el) * 4
    gen_stream_s = gen_bytes / rate
    gen_ops = 25                  # relocate ~6 + ts/key pack ~8 + kx ~7 + sums ~4
    gen_op_s = gen_ops * gen_el / op_rate
    res.update(gen_t=t_gen)
    print(f"gen kernel: {t_gen*1e3:.2f} ms; stream bound {gen_stream_s*1e3:.2f} ms, "
          f"~{gen_ops} op bound {gen_op_s*1e3:.2f} ms -> "
          f"{max(gen_stream_s, gen_op_s)/t_gen*100:.0f}% of bound", flush=True)
    return res


# the probes that reach the probe kernels (K2w, K7, K11-K16), then the
# stage-2 and stage-1 probes of `probes_stage2` and `probes_stage1`
KERNEL_PROBES = {
    "compact": probe_compact,
    "compact_algo": probe_compact_algo,
    "quad": probe_quad,
    "quad_s2": probe_quad_s2,
    "wino_pallas": probe_wino_pallas,
    "wino_ablate": probe_wino_ablate,
    "window_lb": probe_window_lb,
    "stage2_roofline": probe_stage2_roofline,
}
PROBES = {**KERNEL_PROBES, **probes_stage2.PROBES, **probes_stage1.PROBES}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", metavar="probe",
                    help=f"any of {', '.join(PROBES)} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = [p for p in args.probes if p not in PROBES]
    if unknown:
        ap.error(f"unknown probe(s) {unknown}; choose from {', '.join(PROBES)}")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("perf_probe: --device cuda, but torch.cuda.is_available() is false")
        print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(dev)}; "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
              f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    else:
        print(f"devices: {dev} (host clock; CPU numbers, not the card's)", flush=True)
    return {name: PROBES[name](dev) for name in (args.probes or list(PROBES))}


if __name__ == "__main__":
    main(sys.argv[1:])
