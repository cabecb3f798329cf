#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`v2ce_toolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-conv TREE [TREE ...]

The second form runs only phase 8 (below) of the chip_smoke.py of each
checkout TREE, in turns, each in its own process with its own kernel build,
and prints each run's per-window K9 and K10 times: two versions of the
shared conv kernels compared on one card (e.g. parent, change, change,
parent).

Phases, any failure exits non-zero before the result lines:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the CUDA kernels from csrc/ (one nvcc per source, all
     started together, sm_90a), timed;
  3. each kernel against its plain-torch twin on the card, on the inputs
     the stage-2 paths give it for synthetic (24, 2, 10, 260, 346) voxels
     at two densities: K1 gen_compact ('slope' and 'none'), K4 gen_pack
     ('slope' and 'none'), K2 compact_rows (the fused route's calls, the
     chain compaction at grid width P*H*W of the gen_pack route, and every
     call of the bidirectional EventStream route, its one-row side list
     included), K3 merge_sorted_rows (the fused route's calls and the
     per-frame merge of the EventStream route), and K5 append_rows (the
     EventStream flatten). Outputs must be identical. At the dense
     setting: median CUDA-event times of kernel and twin, and each call's
     bound (the bytes it needs, see bound_ms, at the HBM rate);
  4. the CLI (`cli.main`), full-width model on seeded random weights, each
     path counted (launch counters reset just before it and read just
     after; every kernel of the path must have moved): center mode on a
     33-frame 260x346 clip (median of N_CLI warm runs), the same with
     --streaming (the batch run's event total), and -t pano on a 33-frame
     260x600 clip (2 strips, the last right-aligned and trimmed to 254 px;
     the 10-bit x field), batch and --streaming. Every npz must hold
     EVENT_DTYPE records inside the frame, time-sorted;
  5. each stage-2 mode (strategies slope, none and random, pooling avg and
     weighted, bidirectional relocation, use_gen_compact=False), counted,
     on a 4-frame 260x346 chunk: the card against the CPU plain path with
     the same draws, byte-identical decoded events, events > 0; then the
     mode's stage-2 ms/chunk on the card at 24 frames;
  6. stage 1 on the card against the CPU: the full-width model on one
     16-frame 64x96 window, finite, within STAGE1_REL_TOL of the CPU
     output relative to its largest value;
  7. stage 2 alone on the dense synthetic voxels: the kernel path on the
     card against the plain path on the CPU with the same draws,
     byte-identical decoded events, and events > 0;
  8. the research stage-1 convs, K9 conv3d_3x3x3 and K10
     fused_up_concat_conv, against their plain twins on the calls one
     16-frame 260x346 window of the full-width research model makes (14 K9
     calls of 7 shapes, 2 K10 calls), in bf16 and f32 (TF32 off), within
     CONV_REL_TOL (by output dtype) of the twin relative to its largest
     output; per shape the
     median CUDA-event ms of kernel, twin and the cuDNN call computing the
     same function (`library_ms`), and the bound (FLOPs at PEAK_FLOPS or
     bytes at the HBM rate, the larger);
  9. the research configuration end to end (V2cePipeline, bf16,
     RESEARCH), counted: K9 must launch 14 and K10 2 times per window;
     then the product `--bf16` CLI run, counted;
 10. stage 1 of the research model against the product model on the card:
     in f32 within STAGE1_REL_TOL (the phase-6 window and the clip's first
     window), and in bf16 through the bf16 fidelity gate of
     `tests/test_model_rewrites.py:119-163` on the clip's first window
     (max error <= 0.05 scale + 1e-3, BinaryMatch at 0.01 >= 0.995, LDATI
     event count ratio within 0.5% on the same draws, timestamp KS <= 0.02);
 11. the training-data path (`data/mvsec.py`) with the full-width
     FastFlowNet on seeded random weights: (a) K8 correlation against its
     twin on the five pyramid levels of one 16-pair call at 260x346, within
     CORR_REL_TOL, with kernel, twin and bound times (CUDA events around
     one call, and the device alone from CUDA-graph replays), and a
     torch.profiler breakdown of one pair-flow call; (b) FastFlowNet on the
     card against the CPU on 2 pairs (TF32 off), within FLOW_REL_TOL;
     (c) the converter on a synthetic 49-frame 260x346 recording (3
     packets) with the weights from a `.pt` as `--fastflownet_ckpt` loads
     them, counted: K8 must launch 30 times, flows (16, 2, 260, 346) and
     finite, ms per packet and per pair-flow call; (d) EventPackDataset,
     iterate_batches and device_prefetch on the written packets, batch
     shapes and dtypes on the card, and the device voxelizer against the
     numpy one.
 12. the probe harness (`python -m v2ce_toolbox_tpu_torch.tools.perf_probe`)
     and its kernels: (a) against their plain twins on the card at the
     probes' full-width shapes: K11 conv3d_quad on every layer of `quad`
     and `quad_s2` (bf16 and f32, TF32 off) within CONV_REL_TOL, K12
     conv3d_wino4 on the three `wino_pallas` shapes within WINO_REL_TOL
     (by output dtype; the 'nodot' ablation identical), K2w
     compact_rows(algo="window"), K7 layout_barrier and K13-K16
     identical; each with kernel, twin and
     library ms (cuDNN F.conv3d for K11 and K12, clone() for the copies)
     and its bound (K12's from its Winograd FLOPs), and for K2w, K7 and
     K13-K16 the device ms from CUDA-graph replays; K13's device time must
     rise from k=64 to k=256 at a rate under the card's int32 issue rate; (b)
     the probe CLI with all eight probes, counted: every probe kernel must
     launch, and only `wino_ablate [noinv]` may print FAILED.
The line before the last is a JSON object of per-kernel results (its
`launches` is the count of the kernel's own path, KERNEL_PATH, and
`launches_by_path` every counted path's count; K9's and K10's times are
sums over one window's calls, in bf16, K11's over the probe's layers in
bf16, K12's over the three `wino_pallas` shapes in bf16); the last is
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")      # the clips and the CLI outputs
N_TIMED = 15
N_CLI = 3
STAGE1_REL_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
# H100 SXM dense peaks: bf16 tensor cores, and f32 on the CUDA cores (the
# f32 convs must not round to TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# K9/K10 against their twins, relative to the twin's largest output, by
# output dtype: f32 sums run in another order (1e-5); a bf16 output may
# land one bf16 ulp away where an f32 sum straddles a rounding boundary
# (8e-3). K9 returns f32 in both models, K10 the compute dtype.
CONV_REL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# K12 against its twin, f32 out: the two differ only in the order of the
# C-long products z, and F(4,3)'s collapses (AT entries up to 8 on each
# axis) lift one ulp of a partial sum to ~1e-5 of the largest output (the
# f32 twin itself is 1.0e-5 from the exact conv at 8 x 64 x 64 x 192,
# measured on the CPU): 5e-5; a bf16 output as the convs above
WINO_REL_TOL = {"float32": 5e-5, "bfloat16": 8e-3}
RESEARCH = dict(conv_impl="pallas", subpixel_decoder=True, subpixel_impl="pallas",
                subpixel_blocks=2)
CONV_PER_WINDOW = {"conv3d_3x3x3": 14, "fused_up_concat_conv": 2}
FPS, F, H, W = 30, 24, 260, 346            # the stage-2 chunk of the main path
PANO_W = 600
DEVICE = "cuda"
# the data path: 16-frame packets of a 49-frame recording, one pair-flow
# call of 16 pairs a direction; K8 against its twin relative to the twin's
# largest output (f32 sums in another order), the card's FastFlowNet
# against the CPU's relative to the largest |flow| (cuDNN and the CPU sum
# the convs in other orders, through five coarse-to-fine levels)
DATA_FRAMES, PAIRS = 49, 16
CORR_REL_TOL, FLOW_REL_TOL = 1e-5, 1e-4
# the probe phase: timed runs a call (fewer than N_TIMED: 17 conv layers in
# two dtypes), the probe CLI's probes and the roofline's op counts
N_PROBE_TIMED = 7
K_LO, K_HI = 64, 256

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "gen_compact": ("v2ce_toolbox_tpu_torch/csrc/gen_compact.cu",
                    "v2ce_toolbox_tpu/ops/gen_pallas.py:315"),
    "compact_rows": ("v2ce_toolbox_tpu_torch/csrc/compact_rows.cu",
                     "v2ce_toolbox_tpu/ops/compact_pallas.py:226"),
    "merge_sorted_rows": ("v2ce_toolbox_tpu_torch/csrc/merge_rows.cu",
                          "v2ce_toolbox_tpu/ops/compact_pallas.py:492"),
    "gen_pack": ("v2ce_toolbox_tpu_torch/csrc/gen_pack.cu",
                 "v2ce_toolbox_tpu/ops/gen_pallas.py:79"),
    "append_rows": ("v2ce_toolbox_tpu_torch/csrc/merge_rows.cu",
                    "v2ce_toolbox_tpu/ops/compact_pallas.py:361"),
    "conv3d_3x3x3": ("v2ce_toolbox_tpu_torch/csrc/conv3d.cu",
                     "v2ce_toolbox_tpu/ops/conv3d_pallas.py:81"),
    "fused_up_concat_conv": ("v2ce_toolbox_tpu_torch/csrc/decoder_conv.cu",
                             "v2ce_toolbox_tpu/ops/decoder_pallas.py:177"),
    "correlation": ("v2ce_toolbox_tpu_torch/csrc/correlation.cu",
                    "v2ce_toolbox_tpu/ops/correlation.py:43"),
    "compact_rows_window": ("v2ce_toolbox_tpu_torch/csrc/compact_rows.cu",
                            "v2ce_toolbox_tpu/ops/compact_pallas.py:127"),
    "layout_barrier": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu",
                       "v2ce_toolbox_tpu/ops/barrier.py:28"),
    "conv3d_quad": ("v2ce_toolbox_tpu_torch/csrc/conv3d_quad.cu",
                    "v2ce_toolbox_tpu/ops/conv3d_quad.py:121"),
    "conv3d_wino4": ("v2ce_toolbox_tpu_torch/csrc/wino4.cu",
                     "v2ce_toolbox_tpu/ops/winograd_pallas.py:98"),
    "op_chain": ("v2ce_toolbox_tpu_torch/csrc/roofline.cu", "tools/perf_probe.py:2510"),
    "op_chain_ilp": ("v2ce_toolbox_tpu_torch/csrc/roofline.cu", "tools/perf_probe.py:2554"),
    "stream_copy": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu", "tools/perf_probe.py:2597"),
    "stream_copy_row": ("v2ce_toolbox_tpu_torch/csrc/stream_copy.cu",
                        "tools/perf_probe.py:2626"),
}
PROBE_KERNELS = ("compact_rows_window", "layout_barrier", "conv3d_quad", "conv3d_wino4",
                 "op_chain", "op_chain_ilp", "stream_copy", "stream_copy_row")
# the phase-3 case whose time stands in the kernels line
TIMED_CASE = {"gen_compact": "gen_compact[slope]", "compact_rows": "compact_rows",
              "merge_sorted_rows": "merge_sorted_rows", "gen_pack": "gen_pack[slope]",
              "append_rows": "append_rows", "conv3d_3x3x3": "conv3d_3x3x3[bfloat16]",
              "fused_up_concat_conv": "fused_up_concat_conv[bfloat16]",
              "correlation": "correlation", "compact_rows_window": "compact_rows_window",
              "layout_barrier": "layout_barrier", "conv3d_quad": "conv3d_quad[bfloat16]",
              "conv3d_wino4": "conv3d_wino4[bfloat16]", "op_chain": "op_chain",
              "op_chain_ilp": "op_chain_ilp", "stream_copy": "stream_copy",
              "stream_copy_row": "stream_copy_row"}
CENTER_PATH = ("gen_compact", "compact_rows", "merge_sorted_rows")
RESEARCH_PATH = CENTER_PATH + tuple(CONV_PER_WINDOW)
# kernel -> the counted path whose count stands as its `launches` in the
# kernels line: the center CLI run, or the mode that reaches the kernel
KERNEL_PATH = {"gen_compact": "center CLI", "compact_rows": "center CLI",
               "merge_sorted_rows": "center CLI", "gen_pack": "mode gen_pack",
               "append_rows": "mode bidirectional", "conv3d_3x3x3": "research V2cePipeline",
               "fused_up_concat_conv": "research V2cePipeline", "correlation": "mvsec data",
               **{name: "probe CLI" for name in PROBE_KERNELS}}
# stage-2 mode -> (SamplerConfig overrides, its CLI flags or None where
# v2ce.py has no flag for it, the kernels its path launches)
MODES = {
    "slope": ({}, [], CENTER_PATH),
    "none": (dict(additional_events_strategy="none"), ["--stage2_strategy", "none"],
             CENTER_PATH),
    "random": (dict(additional_events_strategy="random"), ["--stage2_strategy", "random"],
               ("compact_rows", "merge_sorted_rows")),
    "avg": (dict(pooling_type="avg"), ["--stage2_pooling", "avg"],
            ("compact_rows", "merge_sorted_rows")),
    "weighted": (dict(pooling_type="weighted"), ["--stage2_pooling", "weighted"],
                 ("compact_rows", "merge_sorted_rows")),
    "bidirectional": (dict(bidirectional=True), None,
                      ("compact_rows", "merge_sorted_rows", "append_rows")),
    "gen_pack": (dict(use_gen_compact=False), None,
                 ("gen_pack", "compact_rows", "merge_sorted_rows")),
}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def record_calls(modules, name, calls):
    """Record the (args, kwargs) of every call of `name` in `modules`."""
    originals = [getattr(m, name) for m in modules]

    def wrap(fn):
        def inner(*args, **kwargs):
            calls.append((args, kwargs))
            return fn(*args, **kwargs)
        return inner

    for m, fn in zip(modules, originals):
        setattr(m, name, wrap(fn))
    try:
        yield calls
    finally:
        for m, fn in zip(modules, originals):
            setattr(m, name, fn)


def flat(out):
    """A kernel output tuple, nested payload tuples flattened."""
    res = []
    for o in out:
        res.extend(o if isinstance(o, tuple) else [o])
    return res


def max_abs_err(a, b):
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    err = 0
    for x, y in zip(fa, fb):
        if x is None or y is None:               # kx of the 'none' strategy
            assert x is None and y is None
            continue
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def nbytes(x):
    """Bytes of the tensors in x (nested lists, tuples and dicts)."""
    if hasattr(x, "element_size"):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(nbytes(y) for y in x.values())
    return 0


def bound_ms(label, args, kwargs, out):
    """Least time of a call at the card's memory rate (its integer and f32
    work is far below the compute bound): the bytes the function needs.
    The generation kernels read every voxel and write their outputs once.
    The row kernels write their outputs once and read a payload word only
    where its key is kept. K2 reads every key, since a row's count of valid
    keys decides where each lands; K3 and K5 take prefix-packed rows, whose
    lengths a search finds, so they need only the kept keys."""
    moved = nbytes(out)
    if label.startswith(("gen_compact", "gen_pack")):
        return (moved + nbytes(args) + nbytes(kwargs)) / HBM_BYTES_PER_S * 1e3
    keys = args[0]
    payloads = args[1] if len(args) > 1 else kwargs.get("payloads", ())
    n_kept = int(out[2].sum())
    moved += nbytes(keys) if label.startswith("compact_rows") else n_kept * keys.element_size()
    moved += sum(n_kept * p.element_size() for p in payloads)
    return moved / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, torch):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_pair(kernel, plain, torch, n=N_TIMED):
    """Median ms of kernel and plain over n runs, in turns."""
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(n):
        order = [(tp, plain), (tk, kernel)] if i % 2 else [(tk, kernel), (tp, plain)]
        for acc, fn in order:
            acc.append(cuda_ms(fn, torch))
    return statistics.median(tk), statistics.median(tp)


class Counted:
    """Runs a path with every launch counter reset just before it and read
    just after; the kernels of the path must all have moved. Keeps each
    path's own counts."""

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.by_path = {}

    def __call__(self, path, kernels, fn, how=""):
        self.torch.cuda.synchronize()
        self.ops.reset_launches()
        out = fn()
        self.torch.cuda.synchronize()
        counts = self.ops.launch_counts()
        log(f"[launches] {path}{f' ({how})' if how else ''}: {counts}")
        missing = [k for k in kernels if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}")
        self.by_path[path] = counts
        return out


def kernels_phase(torch, np, dev):
    """Phase 3: every kernel against its twin on the stage-2 paths' calls.
    Returns ({case: {ms, plain_ms, bound_ms}}, {kernel: max_abs_err},
    (dense voxels, their fused-route events, their draw, offsets))."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import compact, gen, ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver

    scfg = SamplerConfig()
    offsets = torch.from_numpy((np.arange(F) / FPS * 1e6).astype(np.int32)).to(dev)
    kw1 = dict(fps=FPS, mepv=scfg.max_events_per_voxel, vox_bits=ldati.vox_bits_of(2, H, W),
               cap_bin=scfg.cap_bin)
    kw4 = {k: v for k, v in kw1.items() if k != "cap_bin"}
    results, errs, dense = {}, {name: 0 for name in KERNELS}, None
    for density, scale in [(0.05, 1.5), (0.3, 5.0)]:
        g = torch.Generator(device=dev).manual_seed(1234)
        v = ((torch.rand((F, 2, 10, H, W), generator=g, device=dev) < density)
             * torch.rand((F, 2, 10, H, W), generator=g, device=dev) * scale).contiguous()
        draw = ldati.make_draw(0, 0, dev)
        calls = {"compact_rows": [], "merge_sorted_rows": [], "append_rows": [],
                 "compact_rows[stream]": [], "merge_sorted_rows[stream]": []}
        # the fused slope route of the center CLI: K1, K2, K3
        with record_calls([ldati, driver], "compact_rows", calls["compact_rows"]), \
                record_calls([driver], "merge_sorted_rows", calls["merge_sorted_rows"]):
            events = driver._fetch_chunk_events_fused(v, draw, offsets, F, scfg, FPS,
                                                      width=W)
        # the gen_pack route: K4, then the chain compaction at grid width
        grid = []
        with record_calls([ldati], "compact_rows", grid):
            ldati.sample_rows(v, draw, dataclasses.replace(scfg, use_gen_compact=False))
        calls["compact_rows[grid]"] = [c for c in grid if c[0][0].shape[1] == 2 * H * W]
        # the EventStream route (bidirectional): the grid path's K2 calls and
        # the per-frame K3 merge in sample_events, then K5 on the per-frame
        # buffers and the one-row side-list K2 in the flatten
        with record_calls([ldati, driver], "compact_rows", calls["compact_rows[stream]"]), \
                record_calls([ldati], "merge_sorted_rows", calls["merge_sorted_rows[stream]"]), \
                record_calls([driver], "append_rows", calls["append_rows"]):
            stream = ldati.sample_events(v, draw,
                                         dataclasses.replace(scfg, bidirectional=True))
            driver._fetch_chunk_events(stream, offsets, F, FPS, width=W)
        torch.cuda.synchronize()
        cases = [
            ("gen_compact[slope]", gen.gen_compact, gen.gen_compact_torch, [((v,), kw1)]),
            ("gen_compact[none]", gen.gen_compact, gen.gen_compact_torch,
             [((v,), dict(kw1, strategy="none"))]),
            ("gen_pack[slope]", gen.gen_pack, gen.gen_pack_torch, [((v,), kw4)]),
            ("gen_pack[none]", gen.gen_pack, gen.gen_pack_torch,
             [((v,), dict(kw4, strategy="none"))]),
            ("compact_rows", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows"]),
            ("compact_rows[grid]", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows[grid]"]),
            ("compact_rows[stream]", compact.compact_rows, compact.compact_rows_torch,
             calls["compact_rows[stream]"]),
            ("merge_sorted_rows", compact.merge_sorted_rows, compact.merge_sorted_rows_torch,
             calls["merge_sorted_rows"]),
            ("merge_sorted_rows[stream]", compact.merge_sorted_rows,
             compact.merge_sorted_rows_torch, calls["merge_sorted_rows[stream]"]),
            ("append_rows", compact.append_rows, compact.append_rows_torch,
             calls["append_rows"]),
        ]
        case_errs = {}
        for label, kernel, plain, cl in cases:
            if not cl:
                raise AssertionError(f"the stage-2 paths made no {label} call")
            case_errs[label] = max(max_abs_err(kernel(*a, **k), plain(*a, **k))
                                   for a, k in cl)
            name = label.split("[")[0]
            errs[name] = max(errs[name], case_errs[label])
        shapes = {label: [(tuple(a[0].shape), k) for a, k in calls[label]] for label in calls}
        log(f"[kernels] density {density} x{scale}: events {len(events)}, "
            f"max_abs_err {case_errs}, calls {shapes}")
        for label, e in case_errs.items():
            if e != 0:
                raise AssertionError(f"{label} differs from its plain twin: {e}")
        if density != 0.3:
            continue
        dense = (v, events, draw, offsets)
        for label, kernel, plain, cl in cases:
            tk = tp = tb = 0.0
            for a, k in cl:
                x, y = time_pair(lambda: kernel(*a, **k), lambda: plain(*a, **k), torch)
                b = bound_ms(label, a, k, kernel(*a, **k))
                log(f"[time] {label} {tuple(a[0].shape)} {k}: kernel {x:.4f} ms, "
                    f"plain {y:.4f} ms, bound {b:.4f} ms")
                tk, tp, tb = tk + x, tp + y, tb + b
            results[label] = dict(ms=tk, plain_ms=tp, bound_ms=tb)
            log(f"[time] {label} per 24-frame chunk: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
                f"bound {tb:.4f} ms")
    return results, errs, dense


def graph_ms(fn, torch, reps=10):
    """Median device ms of one fn call, from N_TIMED replays of a CUDA
    graph holding `reps` calls: the wrapper's Python, which a CUDA-event
    time of one call includes, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(g.replay, torch) for _ in range(N_TIMED)) / reps


def time_one(fn, torch, n=N_TIMED):
    """Median ms of fn over n runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn, torch) for _ in range(n))


def conv_bound(flops, moved, dname):
    """(bound ms, what bounds it): the larger of the FLOPs at the card's
    peak for the type and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def conv_kernels_phase(torch, np, dev):
    """Phase 8: K9 and K10 against their twins on the calls of one 16-frame
    260x346 window of the full-width research model, bf16 and f32. Returns
    ({"<kernel>[<dtype>]": per-window sums of ms, plain_ms, library_ms,
    bound_ms and bound_by}, {kernel: max abs err in bf16})."""
    import torch.nn.functional as F

    from v2ce_toolbox_tpu_torch.config import ModelConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d, layers
    from v2ce_toolbox_tpu_torch.ops import conv3d, decoder
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, H, W, 2)
                         .astype(np.float32)).to(dev)
    results, errs = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        model = V2ce3d(ModelConfig(compute_dtype=dtype, **RESEARCH))
        init_weights(model, 0)
        model.to(dev).eval()
        k9, k10, k10_in = [], [], []
        with record_calls([layers], "conv3d_3x3x3", k9), \
                record_calls([decoder], "fused_conv_even", k10), \
                record_calls([layers], "fused_up_concat_conv", k10_in), torch.no_grad():
            model(x)
        torch.cuda.synchronize()
        del model
        if len(k9) != CONV_PER_WINDOW["conv3d_3x3x3"] or len(k10) != 2 or len(k10_in) != 2:
            raise AssertionError(f"the research model made {len(k9)} K9 and {len(k10)} K10 "
                                 "calls on one window")
        # K9: the distinct call shapes, each with its count in the window
        shapes = {}
        for a, k in k9:
            key = (tuple(a[0].shape), tuple(a[1].shape))
            shapes.setdefault(key, [a, k, 0])[2] += 1
        cases = [("conv3d_3x3x3", conv3d.conv3d_3x3x3, conv3d._conv3d_3x3x3_torch, a, k, n,
                  None) for a, k, n in shapes.values()]
        # K10: each call with the block's call of fused_up_concat_conv it serves
        cases += [("fused_up_concat_conv", decoder.fused_conv_even,
                   decoder._fused_conv_even_torch, a, k, 1, block_call)
                  for (a, k), block_call in zip(k10, k10_in)]
        for name, kernel, plain, a, k, n, block_call in cases:
            with torch.no_grad():
                got, want = kernel(*a, **k), plain(*a, **k)
                torch.cuda.synchronize()
                rel = rel_err(got, want)
                abs_err = float((got.float() - want.float()).abs().max())
                if name == "conv3d_3x3x3":
                    xin, kin = a
                    flops = 2 * xin.numel() * kin.shape[4] * 27
                    moved = nbytes([xin, kin, got])
                    xl = xin.permute(0, 4, 1, 2, 3)          # channels-last NCDHW
                    wl = kin.permute(4, 3, 0, 1, 2).contiguous()
                    label = f"{tuple(xin.shape)} x {tuple(kin.shape)}"
                else:
                    fa, fkw = block_call
                    coarse, skip, kern = fa[:3]
                    proj = fa[3] if len(fa) > 3 else None
                    b, l, hc, wc, cu = coarse.shape
                    hf, wf, cs = skip.shape[2:]
                    co = kern.shape[4]
                    # the function's work: the direct conv over the fine
                    # concat, and the 1x1 projection when it is fused
                    flops = 2 * b * l * hf * wf * (cu + cs) * co * (27 + (proj is not None))
                    moved = (nbytes([coarse, skip, kern, proj])
                             + b * l * hf * wf * co * got.element_size() * (1 + (proj is not None)))
                    # the library's one call on the materialized concat (made
                    # outside the timing): conv, and the projection as a
                    # centre-tap block of the same weights
                    up = coarse.repeat_interleave(2, 2)[:, :, :hf].repeat_interleave(2, 3)[:, :, :, :wf]
                    xl = torch.cat([up, skip], -1).permute(0, 4, 1, 2, 3).contiguous(
                        memory_format=torch.channels_last_3d)
                    wl = kern.permute(4, 3, 0, 1, 2)
                    if proj is not None:
                        wp = torch.zeros_like(wl)
                        wp[:, :, 1, 1, 1] = proj[0, 0, 0].t()
                        wl = torch.cat([wl, wp], 0)
                    wl = wl.contiguous()
                    if dtype == torch.float32:
                        # the whole fused function (kernel + fold + odd-size
                        # corrections) against the direct conv
                        full = layers.fused_up_concat_conv(*fa, **fkw)
                        full = full[0] if isinstance(full, tuple) else full
                        direct = F.conv3d(xl, wl[:co], padding=1).permute(0, 2, 3, 4, 1)
                    label = (f"coarse {tuple(coarse.shape)} skip {tuple(skip.shape)} Co {co}"
                             f"{' + projection' if proj is not None else ''}")
                    if dtype == torch.float32 and rel_err(full, direct) > STAGE1_REL_TOL:
                        raise AssertionError(f"K10 {label}: the fused conv is "
                                             f"{rel_err(full, direct):.3e} from the direct conv")
                tol = CONV_REL_TOL[str(got.dtype).split(".")[1]]
                if not (torch.isfinite(got.float()).all() and rel <= tol):
                    raise AssertionError(f"{name} {dname} {label}: {rel:.3e} from its twin "
                                         f"(limit {tol:g})")
                tk, tp = time_pair(lambda: kernel(*a, **k), lambda: plain(*a, **k), torch)
                tl = time_one(lambda: F.conv3d(xl, wl, padding=1), torch)
            tb, by = conv_bound(flops, moved, dname)
            log(f"[conv] {name} {dname} {label} x{n}: rel err {rel:.3e} (limit {tol:g}), abs err "
                f"{abs_err:.3e}; kernel {tk:.4f} ms ({flops / tk / 1e9:.1f} TFLOP/s), plain "
                f"{tp:.4f} ms, cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by})")
            r = results.setdefault(f"{name}[{dname}]", dict(ms=0.0, plain_ms=0.0,
                                                             library_ms=0.0, bound_ms=0.0,
                                                             t_ops=0.0, t_bytes=0.0))
            r["ms"] += n * tk
            r["plain_ms"] += n * tp
            r["library_ms"] += n * tl
            r["bound_ms"] += n * tb
            r["t_ops" if by == "operations" else "t_bytes"] += n * tb
            if dtype == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), abs_err)
        del k9, k10, k10_in, cases, shapes
        torch.cuda.empty_cache()
    for label, r in results.items():
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"
        log(f"[conv] {label} per 16-frame window: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results, errs


def make_clip(path, n, h, w):
    import cv2

    from tools.make_test_video import make_frames

    video = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for fr in make_frames(n, h, w):
        video.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    video.release()


def check_npz(result, np, w, what, monotone=True):
    """The npz of a CLI run: EVENT_DTYPE records inside the 260 x w frame of
    the 32 voxel frames, time-sorted, and as many as the run reports.
    'random' (not monotone) draws raw U[0, 1) s offsets past each bin
    start, sorted per bin only."""
    from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE

    ev = np.load(result["event_stream_path"])["event_stream"]
    if ev.dtype != EVENT_DTYPE:
        raise AssertionError(f"{what}: npz dtype {ev.dtype} != {EVENT_DTYPE}")
    t_end = 32 / FPS * 1e6 + (0 if monotone else 1e6 + 1e6 / FPS / 9 + 2)
    if not (len(ev) == result["num_events"] > 0
            and ev["x"].min() >= 0 and ev["x"].max() < w
            and ev["y"].min() >= 0 and ev["y"].max() < H
            and (not monotone or np.all(np.diff(ev["timestamp"]) >= 0))
            and ev["timestamp"].min() >= 0 and ev["timestamp"].max() < t_end):
        raise AssertionError(f"{what}: events outside the {H}x{w} frame, unsorted or "
                             "missing")
    return ev


def cli_line(result):
    t = result["timings"]
    return (f"stage-1 {t['stage1_s'] / t['windows'] * 1e3:.2f} ms/window "
            f"({t['windows']} windows), stage-2 {t['stage2_s'] / t['chunks'] * 1e3:.2f} "
            f"ms/chunk ({t['chunks']} chunks), events {result['num_events']}, "
            f"{result['num_frames'] / result['wall_time_s']:.2f} frames/s "
            f"({result['num_frames']} frames in {result['wall_time_s']:.3f} s)")


def cli_phase(torch, np, counted, smi):
    """Phase 4: center, center --streaming, pano and pano --streaming."""
    from v2ce_toolbox_tpu_torch import cli

    os.makedirs(OUT, exist_ok=True)
    clip = os.path.join(OUT, "clip.mp4")
    make_clip(clip, 33, H, W)
    common = ["-o", OUT, "-m", os.path.join(OUT, "absent.pt"), "--device", DEVICE,
              "--seed", "0", "--height", str(H), "--width", str(W), "-l", "warning"]
    argv = ["-i", clip, *common]
    cli.main(argv)                                   # warm-up (cuDNN, allocator)
    result = counted("center CLI", CENTER_PATH, lambda: cli.main(argv))
    check_npz(result, np, W, "center")
    # the host shares its cores: report the run with the median wall time
    runs = [result] + [cli.main(argv) for _ in range(N_CLI - 1)]
    if len({r["num_events"] for r in runs}) != 1:
        raise AssertionError("repeated CLI runs gave different event counts")
    result = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[cli] center: {cli_line(result)} [{smi}]")

    streamed = counted("center CLI --streaming", CENTER_PATH,
                       lambda: cli.main(argv + ["--streaming"]))
    check_npz(streamed, np, W, "center --streaming")
    log(f"[cli] center --streaming: {cli_line(streamed)} [{smi}]")
    if streamed["num_events"] != result["num_events"]:
        raise AssertionError(f"--streaming gave {streamed['num_events']} events, the "
                             f"batch run {result['num_events']}")

    pano_clip = os.path.join(OUT, "pano.mp4")
    make_clip(pano_clip, 33, H, PANO_W)
    pargv = ["-i", pano_clip, "-t", "pano", *common]
    cli.main(pargv)                                  # warm-up at the pano width
    pano = {}
    x_need = 512 if PANO_W > 512 else W           # the 10-bit x field, or the last strip
    for label, extra in [("pano", []), ("pano --streaming", ["--streaming"])]:
        res = counted(f"{label} CLI", CENTER_PATH, lambda: cli.main(pargv + extra))
        ev = check_npz(res, np, PANO_W, label)
        if res["voxels_shape"] != (32, H, PANO_W, 20) or int(ev["x"].max()) < x_need:
            raise AssertionError(f"{label}: voxels {res['voxels_shape']}, x up to "
                                 f"{int(ev['x'].max())}: the strips miss the width")
        log(f"[cli] {label} ({H}x{PANO_W}, 2 strips, x up to {int(ev['x'].max())}): "
            f"{cli_line(res)} [{smi}]")
        pano[label] = res["num_events"]
    if len(set(pano.values())) != 1:
        raise AssertionError(f"pano event totals differ: {pano}")


def modes_phase(torch, np, counted, dense, smi):
    """Phase 5: each stage-2 mode, the card against the CPU plain path on 4
    frames, then end to end on the center clip, counted: through its CLI
    flag, or through V2cePipeline with the sampler setting where v2ce.py
    has no flag."""
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.config import PipelineConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver

    v, _, _, offsets = dense
    v4, off4 = v[:4].contiguous(), offsets[:4]
    draw = ldati.make_draw(1, 0, v.device)
    clip = os.path.join(OUT, "clip.mp4")
    absent = os.path.join(OUT, "absent.pt")

    def cpu_draw(j, shape):
        return draw(j, shape).cpu()

    for mode, (over, flags, kernels) in MODES.items():
        cfg = dataclasses.replace(SamplerConfig(), **over)
        card = driver.chunk_events(v4, draw, off4, 4, cfg, FPS)
        t0 = time.time()
        plain = driver.chunk_events(v4.cpu(), cpu_draw, off4.cpu(), 4, cfg, FPS)
        cpu_s = time.time() - t0
        if len(card) == 0 or card.tobytes() != plain.tobytes():
            raise AssertionError(f"mode {mode}: the card's stage 2 ({len(card)} events) "
                                 f"differs from the CPU plain path ({len(plain)})")
        if flags is not None:
            argv = ["-i", clip, "-o", OUT, "-m", absent, "--device", DEVICE, "--seed", "0",
                    "--height", str(H), "--width", str(W), "-l", "warning", *flags]
            run, how = (lambda: cli.main(argv)), f"cli {' '.join(flags) or '(defaults)'}"
        else:
            pipe = driver.V2cePipeline(PipelineConfig(height=H, width=W, sampler=cfg),
                                       model_path=absent, device=DEVICE, seed=0)
            run = lambda: pipe.run(input_video_path=clip, out_folder=OUT)  # noqa: E731
            how = f"V2cePipeline {over}"
        runs = [counted(f"mode {mode}", kernels, run, how)] + [run() for _ in range(2)]
        for r in runs:
            check_npz(r, np, W, f"mode {mode}", monotone=mode != "random")
        r = sorted(runs, key=lambda r: r["timings"]["stage2_s"])[1]
        log(f"[mode] {mode}: 4-frame chunk card == CPU plain ({len(card)} events, CPU "
            f"{cpu_s:.1f} s); {how}, median of 3: {cli_line(r)} [{smi}]")


def research_phase(torch, np, counted, smi):
    """Phase 9: the research configuration through V2cePipeline on the
    center clip, counted (K9 14 and K10 2 launches per window), then the
    product --bf16 CLI run, counted."""
    from v2ce_toolbox_tpu_torch import cli
    from v2ce_toolbox_tpu_torch.config import ModelConfig, PipelineConfig
    from v2ce_toolbox_tpu_torch.pipeline import driver

    clip = os.path.join(OUT, "clip.mp4")
    absent = os.path.join(OUT, "absent.pt")
    model = ModelConfig(compute_dtype=torch.bfloat16, **RESEARCH)
    pipe = driver.V2cePipeline(PipelineConfig(height=H, width=W, model=model),
                               model_path=absent, device=DEVICE, seed=0)
    run = lambda: pipe.run(input_video_path=clip, out_folder=OUT)  # noqa: E731
    run()                                            # warm-up
    path = "research V2cePipeline"
    runs = [counted(path, RESEARCH_PATH, run, f"bf16, {RESEARCH}")]
    counts, windows = counted.by_path[path], runs[0]["timings"]["windows"]
    for name, per_window in CONV_PER_WINDOW.items():
        if counts[name] != per_window * windows:
            raise AssertionError(f"{path}: {name} launched {counts[name]} times in "
                                 f"{windows} windows, not {per_window} per window")
    runs += [run() for _ in range(N_CLI - 1)]
    for r in runs:
        check_npz(r, np, W, path)
    r = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[research] {path} (bf16), median of {N_CLI}: {cli_line(r)} [{smi}]")

    argv = ["-i", clip, "-o", OUT, "-m", absent, "--device", DEVICE, "--seed", "0",
            "--height", str(H), "--width", str(W), "-l", "warning", "--bf16"]
    cli.main(argv)                                   # warm-up
    runs = [counted("bf16 CLI", CENTER_PATH, lambda: cli.main(argv), "--bf16")]
    runs += [cli.main(argv) for _ in range(N_CLI - 1)]
    for r in runs:
        check_npz(r, np, W, "--bf16")
    if len({r["num_events"] for r in runs}) != 1:
        raise AssertionError("repeated --bf16 runs gave different event counts")
    r = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    log(f"[research] --bf16 CLI, median of {N_CLI}: {cli_line(r)} [{smi}]")


def research_stage1_phase(torch, np, dev, product, x):
    """Phase 10: the research model against the product model on the card,
    the same weights: f32 within STAGE1_REL_TOL on the phase-6 window and
    the clip's first window; bf16 through the fidelity gate on the clip's
    first window."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.io.video import VideoReader
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.pipeline.infer import make_forward_fn
    from v2ce_toolbox_tpu_torch.pipeline.preprocess import resize_frames

    def research(dtype):
        m = V2ce3d(ModelConfig(compute_dtype=dtype, **RESEARCH))
        m.load_state_dict(product.state_dict())
        return m.to(dev).eval()

    r32, r16 = research(torch.float32), research(torch.bfloat16)
    raw = VideoReader(os.path.join(OUT, "clip.mp4"), color_mode="GRAY") \
        .read_frames_at_indices(range(17))
    frames = torch.from_numpy(resize_frames(raw, H)[None]).to(dev)
    with torch.no_grad():
        for what, inp in [("(1, 16, 64, 96, 2) window", lambda m: m(x)),
                          ("clip window", lambda m: make_forward_fn(m, width=W)(frames))]:
            want, got = inp(product), inp(r32)
            rel = rel_err(got, want)
            log(f"[stage1] research f32 vs product f32, {what}: relative to max |out| "
                f"{rel:.3e} (limit {STAGE1_REL_TOL:g})")
            if not torch.isfinite(got).all() or float(want.abs().max()) == 0 \
                    or rel > STAGE1_REL_TOL:
                raise AssertionError(f"the f32 research model disagrees with the product "
                                     f"model on the {what}")
        y32 = make_forward_fn(product, width=W)(frames)
        y16 = make_forward_fn(r16, width=W)(frames)
    err, scale = float((y16 - y32).abs().max()), float(y32.abs().max())
    match = float(((y32 > 0.01) == (y16 > 0.01)).float().mean())

    def events(y):
        v = y.permute(0, 1, 4, 2, 3).reshape(16, 2, 10, H, W).contiguous()
        offsets = torch.from_numpy((np.arange(16) / FPS * 1e6).astype(np.int32)).to(dev)
        return driver.chunk_events(v, ldati.make_draw(7, 0, dev), offsets, 16,
                                   SamplerConfig(), FPS)

    e32, e16 = events(y32), events(y16)
    ratio = len(e16) / max(len(e32), 1)
    a = np.sort(e32["timestamp"].astype(np.float64))
    b = np.sort(e16["timestamp"].astype(np.float64))
    grid = np.union1d(a, b)
    ks = float(np.abs(np.searchsorted(a, grid, side="right") / max(len(a), 1)
                      - np.searchsorted(b, grid, side="right") / max(len(b), 1)).max())
    log(f"[stage1] research bf16 vs product f32, clip window: max err {err:.4e} (limit "
        f"{0.05 * scale + 1e-3:.4e}), BinaryMatch {match:.6f} (>= 0.995), events "
        f"{len(e16)} / {len(e32)} = {ratio:.6f} (within 0.005 of 1), timestamp KS {ks:.6f} "
        "(<= 0.02)")
    if not (len(e32) > 0 and err <= 0.05 * scale + 1e-3 and match >= 0.995
            and abs(ratio - 1) <= 0.005 and ks <= 0.02):
        raise AssertionError("the bf16 research model fails the bf16 fidelity gate")


def make_recording(np, n, h, w, seed=0):
    """A synthetic DAVIS recording of n frames at FPS: the moving test
    pattern, one event per pixel whose intensity changes by more than 8
    levels between two frames (at a random time in the interval, polarity
    the sign of the change), and a 1 kHz IMU. Returns the arrays of an
    MVSEC `davis/left` group."""
    from tools.make_test_video import make_frames

    rng = np.random.RandomState(seed)
    images = make_frames(n, h, w, seed)
    image_ts = np.arange(n) / FPS
    rows = []
    for i in range(n - 1):
        diff = images[i + 1].astype(np.int32) - images[i].astype(np.int32)
        ys, xs = np.nonzero(np.abs(diff) > 8)
        t = image_ts[i] + rng.rand(len(ys)) / FPS
        rows.append(np.stack([xs, ys, t, np.sign(diff[ys, xs])], 1))
    events = np.concatenate(rows)
    events = events[np.argsort(events[:, 2], kind="stable")]
    event_inds = np.searchsorted(events[:, 2], image_ts)
    imu_ts = np.arange(0, image_ts[-1], 1e-3)
    return images, image_ts, event_inds, events, rng.randn(len(imu_ts), 6), imu_ts


def profile_pair_flow(torch, fn, smi, top=8):
    """torch.profiler over one warm pair-flow call: wall ms, the device's
    busy ms (the sum of its kernels' and copies' times; the operators that
    launch them are left out, so nothing counts twice) and the kernels
    that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")]
    busy = sum(r[1] for r in rows)
    if not rows:
        log(f"[profile] pair-flow call: {wall:.2f} ms wall; device time not measured (the "
            "profiler saw no device activity)")
        return
    rows.sort(key=lambda r: -r[1])
    log(f"[profile] pair-flow call ({PAIRS} pairs): {wall:.2f} ms wall, device busy "
        f"{busy:.2f} ms ({busy / wall:.1%}) [{smi}]")
    for name, ms, count in rows[:top]:
        log(f"[profile]   {ms:8.3f} ms {ms / busy:6.1%} x{count:<4d} {name[:90]}")


def data_phase(torch, np, dev, counted, smi):
    """Phase 11: the training-data path. Returns ({"correlation": per-call
    sums of ms, plain_ms, device_ms, plain_device_ms, bound_ms, bound_by,
    library_ms}, K8's max abs error)."""
    import pickle

    from v2ce_toolbox_tpu_torch.data import mvsec
    from v2ce_toolbox_tpu_torch.data.event_pack_dataset import EventPackDataset
    from v2ce_toolbox_tpu_torch.data.loader import device_prefetch, iterate_batches
    from v2ce_toolbox_tpu_torch.data.voxelize import (gen_discretized_event_volume,
                                                      gen_discretized_event_volume_np)
    from v2ce_toolbox_tpu_torch.models import fastflownet
    from v2ce_toolbox_tpu_torch.models.fastflownet import FastFlowNet, init_fastflownet
    from v2ce_toolbox_tpu_torch.ops import correlation
    from v2ce_toolbox_tpu_torch.utils.weights import load_fastflownet

    n = DATA_FRAMES
    rec = make_recording(np, n, H, W)
    images = rec[0]
    net = FastFlowNet()
    init_fastflownet(net, 0)
    ckpt = os.path.join(OUT, "fastflownet.pt")
    torch.save(net.state_dict(), ckpt)
    sd = load_fastflownet(ckpt)

    # (a) K8 against its twin on the calls of one 16-pair call
    pair_flow = mvsec.fastflownet_pair_flow(sd, device=DEVICE)
    calls = []
    with record_calls([fastflownet], "correlation", calls):
        pair_flow(images[:PAIRS], images[1:PAIRS + 1])
    torch.cuda.synchronize()
    if len(calls) != 5:
        raise AssertionError(f"one FastFlowNet call made {len(calls)} cost volumes, not 5")
    r = dict(ms=0.0, plain_ms=0.0, device_ms=0.0, plain_device_ms=0.0, bound_ms=0.0,
             bound_by="bytes", library_ms=None)
    err = 0.0
    t_ops = t_bytes = 0.0
    for a, k in calls:
        f1, f2 = a[:2]
        got, want = correlation.correlation(*a, **k), correlation._correlation_torch(*a, **k)
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        err = max(err, float((got - want).abs().max()))
        if not (torch.isfinite(got).all() and rel <= CORR_REL_TOL):
            raise AssertionError(f"correlation {tuple(f1.shape)}: {rel:.3e} from its twin "
                                 f"(limit {CORR_REL_TOL:g})")
        tk, tp = time_pair(lambda: correlation.correlation(*a, **k),
                           lambda: correlation._correlation_torch(*a, **k), torch)
        dk = graph_ms(lambda: correlation.correlation(*a, **k), torch)
        dp = graph_ms(lambda: correlation._correlation_torch(*a, **k), torch, reps=1)
        # each input read once, the 81 planes written once; a multiply-add
        # per channel, tap and pixel
        flops = 2 * f1.numel() * got.shape[1]
        tb, by = conv_bound(flops, nbytes([f1, f2, got]), "float32")
        t_ops += flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes += nbytes([f1, f2, got]) / HBM_BYTES_PER_S * 1e3
        log(f"[data] correlation {tuple(f1.shape)} -> {tuple(got.shape)}: rel err {rel:.3e} "
            f"(limit {CORR_REL_TOL:g}); kernel {tk:.4f} ms ({dk:.4f} on the device), plain "
            f"{tp:.4f} ms ({dp:.4f}), bound {tb:.4f} ms ({by})")
        r["ms"] += tk
        r["plain_ms"] += tp
        r["device_ms"] += dk
        r["plain_device_ms"] += dp
        r["bound_ms"] += tb
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"[data] correlation per {PAIRS}-pair call (5 levels): kernel {r['ms']:.4f} ms "
        f"({r['device_ms']:.4f} on the device), plain {r['plain_ms']:.4f} ms "
        f"({r['plain_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")
    del calls
    profile_pair_flow(torch, lambda: pair_flow(images[:PAIRS], images[1:PAIRS + 1]), smi)

    # (b) FastFlowNet on the card against the CPU, the same weights
    cpu_flow = mvsec.fastflownet_pair_flow(sd, device="cpu")
    got, want = pair_flow(images[:2], images[1:3]), cpu_flow(images[:2], images[1:3])
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[data] FastFlowNet card vs CPU, 2 pairs {H}x{W}: flow up to "
        f"{float(np.abs(want).max()):.4f} px, relative error {rel:.3e} (limit {FLOW_REL_TOL:g})")
    if got.shape != (2, 2, H, W) or not np.isfinite(got).all() or rel > FLOW_REL_TOL:
        raise AssertionError("FastFlowNet on the card disagrees with the CPU")

    # (c) the converter, counted. The GPU machine's Python installation
    # has no h5py, so this drives `convert_mvsec_arrays`, the command
    # line's steps after its h5 read, with the weights loaded from the .pt
    # as `--fastflownet_ckpt` loads them.
    log("[data] h5py is not installed on the card: the h5 reader (convert_mvsec_h5, the "
        "command line) ran only in the CPU tests; this drives convert_mvsec_arrays")
    flow_s = []

    def timed(fn):
        def inner(a, b):
            t0 = time.time()
            out = fn(a, b)                       # numpy out: the card has finished
            flow_s.append(time.time() - t0)
            return out
        return inner

    out_dir = os.path.join(OUT, "packets")
    convert = lambda d: mvsec.convert_mvsec_arrays(  # noqa: E731
        *rec, d, "synth_left", pair_flow_fn=timed(mvsec.fastflownet_pair_flow(sd, device=DEVICE)))
    convert(os.path.join(OUT, "packets_warm"))           # warm-up (cuDNN, allocator)
    flow_s.clear()
    t0 = time.time()
    written = counted("mvsec data", ("correlation",), lambda: convert(out_dir),
                      f"convert_mvsec_arrays, {n} frames {H}x{W}, FastFlowNet from {ckpt}")
    wall = time.time() - t0
    launches = counted.by_path["mvsec data"]["correlation"]
    if written != (n - 1) // 16 or launches != 10 * written:
        raise AssertionError(f"{written} packets and {launches} K8 launches, expected "
                             f"{(n - 1) // 16} and {10 * ((n - 1) // 16)}")
    names = sorted(os.listdir(out_dir))
    for i, name in enumerate(names):
        with open(os.path.join(out_dir, name), "rb") as f:
            pkt = pickle.load(f)
        for key in ("optical_flow", "acc_flow"):
            v = pkt[key]
            if v.shape != (16, 2, H, W) or v.dtype != np.float32 or not np.isfinite(v).all():
                raise AssertionError(f"{name} {key}: {v.shape} {v.dtype}, or not finite")
        if i == 0 and not np.array_equal(pkt["acc_flow"][0], pkt["optical_flow"][0]):
            raise AssertionError("the file's first acc_flow is not its forward flow")
    log(f"[data] {written} packets in {wall:.3f} s: {wall / written * 1e3:.2f} ms a packet, "
        f"{statistics.median(flow_s) * 1e3:.2f} ms a pair-flow call (median of "
        f"{len(flow_s)}, {PAIRS} pairs), K8 {launches} launches [{smi}]")

    # (d) the packets back into batches on the card
    ds = EventPackDataset("train", out_dir)
    t0 = time.time()
    host = list(iterate_batches(ds, 2, num_workers=2))
    t1 = time.time()
    batches = list(device_prefetch(iter(host), device=DEVICE))
    torch.cuda.synchronize()
    load_s, copy_s = t1 - t0, time.time() - t1
    want = {"image_units": (2, 16, H, W, 2), "voxels": (2, 16, H, W, 20), "imu": (2, 16, 6),
            "flows": (2, 16, H, W, 4), "lfr": (2, 16, H, W, 1)}
    b = batches[0] if len(batches) == 1 else {}
    shapes = {k: (tuple(v.shape), str(v.dtype), v.device.type) for k, v in b.items()}
    if (sorted(b) != sorted(want) or any(
            shapes[k] != (want[k], "torch.float32", dev.type) for k in want)
            or not all(torch.isfinite(v).all() for v in b.values())):
        raise AssertionError(f"the dataset's batches: {len(batches)}, {shapes}")
    log(f"[data] EventPackDataset -> iterate_batches: 1 batch of 2 in {load_s * 1e3:.1f} ms "
        f"(host); device_prefetch {copy_s * 1e3:.1f} ms ({nbytes(batches) / 1e6:.1f} MB "
        f"pinned and copied); {shapes}")
    # the device voxelizer against the numpy one on one interval's events
    ev = mvsec._to_structured(rec[3][rec[2][0]:rec[2][1]])
    ref = gen_discretized_event_volume_np(ev, (20, H, W))
    t = lambda f: torch.from_numpy(ev[f].astype(np.int32)).to(dev)  # noqa: E731
    vol = gen_discretized_event_volume(t("timestamp"), t("x"), t("y"), t("polarity"),
                                       torch.ones(len(ev), dtype=torch.bool, device=dev),
                                       (20, H, W)).cpu().numpy()
    # f32 timestamps (the jnp version's arithmetic) against the numpy
    # splat's f64: the JAX package's own bound for the pair, 1e-4
    rel = float(np.abs(vol - ref).max() / np.abs(ref).max())
    log(f"[data] gen_discretized_event_volume on the card, {len(ev)} events: {rel:.3e} "
        f"relative to the numpy splat (limit 1e-4)")
    if rel > 1e-4:
        raise AssertionError("the device voxelizer disagrees with the numpy one")
    return {"correlation": r}, err


def int32_issue_rate(torch):
    """The card's issue ceiling for one-lane integer ops, in ops/s: SMs x 4
    schedulers x 32 lanes a clock at the top SM clock nvidia-smi reports
    (no integer op issues faster; the INT32 pipe alone is half of it)."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 128 * mhz * 1e6


class Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def probe_phase(torch, np, dev, counted, smi):
    """Phase 12: the probe harness's kernels against their twins at the
    probes' full-width shapes, then the probe CLI, counted. Returns
    ({case: ms, plain_ms, library_ms, bound_ms, bound_by, ...}, {kernel:
    max abs err}, the stage-2 roofline's measured rates)."""
    import torch.nn.functional as F

    from v2ce_toolbox_tpu_torch.ops import barrier, compact, conv3d_quad, conv3d_wino4, roofline
    from v2ce_toolbox_tpu_torch.tools import perf_probe

    n = N_PROBE_TIMED
    results, errs = {}, {}

    def add(label, tk, tp, tl, tb, by, **extra):
        r = results.setdefault(label, dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                                           t_ops=0.0, t_bytes=0.0))
        r["ms"] += tk
        r["plain_ms"] += tp
        if tl is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + tl
        r["bound_ms"] += tb
        r["t_ops" if by == "operations" else "t_bytes"] += tb
        r.update(extra)

    def check_conv(name, label, got, want, dname):
        rel = rel_err(got, want)
        tol = (WINO_REL_TOL if name == "conv3d_wino4" else CONV_REL_TOL)[
            str(got.dtype).split(".")[1]]
        abs_err = float((got.float() - want.float()).abs().max())
        if not (torch.isfinite(got.float()).all() and got.shape == want.shape and rel <= tol):
            raise AssertionError(f"{name} {dname} {label}: {rel:.3e} from its twin "
                                 f"(limit {tol:g})")
        if dname == "bfloat16":
            errs[name] = max(errs.get(name, 0.0), abs_err)
        return rel, tol

    # (a) K11 on every layer of `quad` (stride 1) and `quad_s2` (stride 1,2,2)
    layers = ([(lay, False) for lay in perf_probe.QUAD_LAYERS]
              + [(lay, True) for lay in perf_probe.QUAD_S2_LAYERS])
    for (name, h, w, cin, cout), strided in layers:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(cin * cout)
            x = torch.rand((1, 16, h, w, cin), generator=g, device=dev).to(dtype)
            k = (torch.rand((3, 3, 3, cin, cout), generator=g, device=dev) * 0.01).to(dtype)
            if strided:
                kernel = lambda: conv3d_quad.conv3d_quad_s122(x, k)  # noqa: E731
                plain = lambda: conv3d_quad._quad_core_torch(*conv3d_quad.fold_s122(x, k))  # noqa: E731
                stride, ho, wo = (1, 2, 2), -(-h // 2), -(-w // 2)
            else:
                kernel = lambda: conv3d_quad.conv3d_quad(x, k)  # noqa: E731
                plain = lambda: conv3d_quad._quad_core_torch(  # noqa: E731
                    F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), k)
                stride, ho, wo = 1, h, w
            with torch.no_grad():
                got = kernel()
                rel, tol = check_conv("conv3d_quad", name, got, plain(), dname)
                xl, wl = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2).contiguous()
                flops = 2 * 16 * ho * wo * cin * cout * 27
                tb, by = conv_bound(flops, nbytes([x, k, got]), dname)
                tk, tp = time_pair(kernel, plain, torch, n)
                tl = time_one(lambda: F.conv3d(xl, wl, stride=stride, padding=1), torch, n)
            log(f"[probe] conv3d_quad {dname} {name} (1, 16, {h}, {w}, {cin}) -> {cout}"
                f"{' stride (1,2,2)' if strided else ''}: rel err {rel:.3e} (limit {tol:g}); "
                f"kernel {tk:.4f} ms ({flops / tk / 1e9:.1f} TFLOP/s), plain {tp:.4f} ms, "
                f"cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by})")
            add(f"conv3d_quad[{dname}]", tk, tp, tl, tb, by)
            del x, k, got, xl, wl
    torch.cuda.empty_cache()

    # K12 on the three `wino_pallas` shapes; 'nodot' identical to the twin
    for name, xshape, cout in perf_probe.WINO_SHAPES:
        cin = xshape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(cin * cout)
            x = (torch.rand(xshape, generator=g, device=dev) - 0.5).to(dtype)
            k = (torch.rand((3, 3, 3, cin, cout), generator=g, device=dev) * 0.05).to(dtype)
            kernel = lambda: conv3d_wino4.conv3d_wino4(x, k)  # noqa: E731
            plain = lambda: conv3d_wino4._conv3d_wino4_torch(x, k)  # noqa: E731
            with torch.no_grad():
                got = kernel()
                rel, tol = check_conv("conv3d_wino4", name, got, plain(), dname)
                same = torch.equal(conv3d_wino4.conv3d_wino4(x, k, ablate="nodot"),
                                   conv3d_wino4._conv3d_wino4_torch(x, k, ablate="nodot"))
                if not same:
                    raise AssertionError(f"conv3d_wino4 {dname} {name}: 'nodot' differs from "
                                         "its twin")
                xl, wl = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2).contiguous()
                # the TPU kernel's own cost: the direct conv's FLOPs x 36 / 144
                flops = 2 * int(np.prod(xshape[:4])) * cin * cout * 27 * 36 // 144
                tb, by = conv_bound(flops, nbytes([x, k, got]), dname)
                tk, tp = time_pair(kernel, plain, torch, n)
                tl = time_one(lambda: F.conv3d(xl, wl, padding=1), torch, n)
            log(f"[probe] conv3d_wino4 {dname} {name} {xshape} -> {cout}: rel err {rel:.3e} "
                f"(limit {tol:g}), 'nodot' identical; kernel {tk:.4f} ms, plain {tp:.4f} ms, "
                f"cuDNN {tl:.4f} ms, bound {tb:.4f} ms ({by}, {flops / 1e9:.1f} Winograd GFLOP)")
            add(f"conv3d_wino4[{dname}]", tk, tp, tl, tb, by)
            del x, k, got, xl, wl
    torch.cuda.empty_cache()

    def add_exact(name, label, kernel, plain, library, bound, by="bytes", **extra):
        """An integer or copy kernel: identical to its twin; CUDA-event ms of
        kernel, twin and library call, and the kernel's device ms from
        CUDA-graph replays (these kernels take less time than the wrapper's
        Python). Returns the device ms."""
        got, want = kernel(), plain()
        err = max_abs_err(got if isinstance(got, tuple) else (got,),
                          want if isinstance(want, tuple) else (want,))
        if err != 0:
            raise AssertionError(f"{name} {label} differs from its plain twin: {err}")
        errs[name] = 0
        tk, tp = time_pair(kernel, plain, torch, n)
        tl = time_one(library, torch, n) if library is not None else None
        dk = graph_ms(kernel, torch)
        log(f"[probe] {name} {label}: identical; kernel {tk:.4f} ms ({dk:.4f} on the device), "
            f"plain {tp:.4f} ms, library {'-' if tl is None else f'{tl:.4f} ms'}, bound "
            f"{bound:.4f} ms ({by})")
        add(name, tk, tp, tl, bound, by, device_ms=dk, **extra)
        return dk

    # K2w at the chain-compaction shape of `compact_algo`, with the payload
    rng = np.random.RandomState(0)
    r, nn = 144, 2048 * 89
    keys = np.where(rng.rand(r, nn) < 0.1, rng.randint(0, 1 << 30, (r, nn)),
                    compact.INVALID).astype(np.int32)
    pays = np.where(keys != compact.INVALID, rng.randint(1, 1 << 20, (r, nn)), 0)
    kk = torch.from_numpy(keys).to(dev)
    pp = torch.from_numpy(pays.astype(np.int32)).to(dev)
    kw = dict(cap=1 << 14, chunk=16384)
    out = compact.compact_rows(kk, [pp], algo="window", **kw)
    add_exact("compact_rows_window", f"({r}, {nn}) cap {kw['cap']} chunk {kw['chunk']}",
              lambda: compact.compact_rows(kk, [pp], algo="window", **kw),
              lambda: compact.compact_rows_torch(kk, [pp], **kw), None,
              bound_ms("compact_rows", (kk, [pp]), kw, out))
    del kk, pp, out

    # K7 on the window's voxels
    vox = torch.rand((1, 16, H, W, 20), device=dev)
    add_exact("layout_barrier", f"{tuple(vox.shape)} f32", lambda: barrier.layout_barrier(vox),
              lambda: barrier._layout_barrier_torch(vox), vox.clone,
              2 * nbytes(vox) / HBM_BYTES_PER_S * 1e3)
    del vox

    # K13-K16 at the roofline's grid: (144, 11, 128, 128) int32. The op
    # chains' bound counts the ops that touch data, an XOR and an add a round
    # and chain (k/2 an element: the rolls are a change of position and the
    # lane test a constant of it), at the card's int32 issue rate; their
    # rate, as the JAX probe's, counts the TPU's four vector ops a round (k
    # el-ops an element), from the device times at two k
    sc, n_chunks = 16384 // 128, -(-(2 * H * W) // 16384)
    xr = torch.from_numpy(rng.randint(0, 1 << 30, (144, n_chunks, sc, 128))
                          .astype(np.int32)).to(dev)
    total_el = xr.numel()
    issue = int32_issue_rate(torch)
    rates = {}
    for name, fn, plain in [("op_chain", roofline.op_chain, roofline._op_chain_torch),
                            ("op_chain_ilp", roofline.op_chain_ilp,
                             roofline._op_chain_ilp_torch)]:
        ts = {}
        for kk_ in (K_LO, K_HI):
            t_ops = kk_ // 2 * total_el / issue * 1e3
            t_bytes = (nbytes(xr) + total_el // n_chunks * 4) / HBM_BYTES_PER_S * 1e3
            bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            if kk_ == K_HI:
                ts[kk_] = add_exact(name, f"k={kk_}", lambda: fn(xr, kk_), lambda: plain(xr, kk_),
                                    None, bound, by, k=kk_)
            else:
                got = fn(xr, kk_)
                if not torch.equal(got, plain(xr, kk_)):
                    raise AssertionError(f"{name} k={kk_} differs from its plain twin")
                ts[kk_] = graph_ms(lambda: fn(xr, kk_), torch)
                log(f"[probe] {name} k={kk_}: identical; {ts[kk_]:.4f} ms on the device, bound "
                    f"{bound:.4f} ms ({by})")
        rate = (K_HI - K_LO) * total_el / ((ts[K_HI] - ts[K_LO]) / 1e3)
        rates[name] = rate
        results[name].update(k_lo_device_ms=ts[K_LO], el_ops_per_s=rate,
                             issue_el_ops_per_s=issue)
        log(f"[probe] {name}: on the device k={K_LO} {ts[K_LO]:.4f} ms, k={K_HI} "
            f"{ts[K_HI]:.4f} ms -> {rate / 1e12:.3f} T el-ops/s, {rate / issue:.1%} of the int32 "
            f"issue rate {issue / 1e12:.2f} T/s [{smi}]")
        if name == "op_chain" and not (ts[K_HI] > ts[K_LO] and rate < issue):
            raise AssertionError(f"{name}: the time does not rise with k at a rate under the "
                                 f"card's int32 issue rate ({ts}, {rate:.3e} ops/s)")
    copy_bound = 2 * nbytes(xr) / HBM_BYTES_PER_S * 1e3
    for name, fn in [("stream_copy", roofline.stream_copy),
                     ("stream_copy_row", roofline.stream_copy_row)]:
        tk = add_exact(name, f"{tuple(xr.shape)} int32", lambda: fn(xr),
                       lambda: roofline._stream_copy_torch(xr), xr.clone, copy_bound)
        rates[name] = 2 * nbytes(xr) / (tk / 1e3)
        results[name]["bytes_per_s"] = rates[name]
        log(f"[probe] {name}: {rates[name] / 1e9:.1f} GB/s read + write on the device, "
            f"{rates[name] / HBM_BYTES_PER_S:.1%} of the nominal 3.35 TB/s [{smi}]")
    del xr
    torch.cuda.empty_cache()
    for r in results.values():
        r["bound_by"] = "operations" if r.pop("t_ops") >= r.pop("t_bytes") else "bytes"

    # (b) the probe CLI, all eight probes, counted
    probes = list(perf_probe.PROBES)
    tee = Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        probe_out = counted("probe CLI", PROBE_KERNELS + ("compact_rows", "gen_pack"),
                            lambda: perf_probe.main(probes),
                            f"python -m v2ce_toolbox_tpu_torch.tools.perf_probe "
                            f"{' '.join(probes)}")
    text = "".join(tee.parts)
    failed = [ln.split(":")[0] for ln in text.splitlines() if "FAILED" in ln]
    if failed != ["wino4 bf16 [noinv]", "wino4 f32 [noinv]"]:
        raise AssertionError(f"the probe CLI printed FAILED for {failed}, not only for "
                             "wino_ablate [noinv]")
    roof = probe_out["stage2_roofline"]
    log(f"[probe] the probe CLI ran in {time.time() - t0:.1f} s; FAILED only for {failed}; "
        f"stage2_roofline: serial {roof['op_rate'] / 1e12:.3f} T el-ops/s, 4 chains "
        f"{roof['ilp_rate'] / 1e12:.3f}, stream copy {roof['stream_rate'] / 1e9:.1f} GB/s "
        f"(64 KB blocks), {roof['row_rate'] / 1e9:.1f} GB/s (704 KB blocks) [{smi}]")
    return results, errs, {"phase 12": rates, "probe CLI": {k: roof[k] for k in (
        "op_rate", "ilp_rate", "stream_rate", "row_rate")}}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.time()
    sys.path.insert(0, ROOT)
    import numpy as np

    from v2ce_toolbox_tpu_torch import ops
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import _cuda
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    t0 = time.time()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"[build] {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'})")

    # 3. kernels against their plain twins at the main-path shapes
    results, errs, dense = kernels_phase(torch, np, dev)
    dense_v, dense_events, dense_draw, offsets = dense

    # 8. (first, while the card holds nothing else) K9 and K10 against their
    # twins at the research model's calls
    conv_results, conv_errs = conv_kernels_phase(torch, np, dev)
    results.update(conv_results)
    errs.update(conv_errs)

    # 4. the CLI paths, counted
    counted = Counted(torch, ops)
    cli_phase(torch, np, counted, smi)

    # 5. the other stage-2 modes, counted
    modes_phase(torch, np, counted, dense, smi)

    # 9. the research configuration and --bf16, counted
    research_phase(torch, np, counted, smi)

    # 11. the training-data path, counted
    data_results, errs["correlation"] = data_phase(torch, np, dev, counted, smi)
    results.update(data_results)

    # 12. the probe harness and its kernels, counted
    probe_results, probe_errs, roofline_rates = probe_phase(torch, np, dev, counted, smi)
    results.update(probe_results)
    errs.update(probe_errs)
    for name in KERNELS:
        if counted.by_path[KERNEL_PATH[name]][name] <= 0:
            raise AssertionError(f"{KERNEL_PATH[name]} never launched {name}")

    # 6. stage 1 on the card against the CPU: the full-width model, seeded
    # weights, one 16-frame window of 64x96 (TF32 off; cuDNN and the CPU
    # sum the conv products in other orders)
    model = V2ce3d(ModelConfig())
    init_weights(model, 0)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 64, 96, 2)
                         .astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"[stage1] card vs CPU, (1, 16, 64, 96, 2) -> {tuple(got.shape)}: max abs err "
        f"{float((got - ref).abs().max()):.3e}, relative to max |out| {rel:.3e} "
        f"(limit {STAGE1_REL_TOL:g})")
    if (got.shape != (1, 16, 64, 96, 20) or not torch.isfinite(got).all()
            or float(ref.abs().max()) == 0 or rel > STAGE1_REL_TOL):
        raise AssertionError("stage 1 on the card disagrees with the CPU")

    # 10. the research model against the product model on the card
    research_stage1_phase(torch, np, dev, model, x.to(dev))

    # 7. stage 2 alone: kernel path (card) against the plain path (CPU)
    t0 = time.time()
    plain = driver._fetch_chunk_events_fused(
        dense_v.cpu(), lambda j, shape: dense_draw(j, shape).cpu(), offsets.cpu(), F,
        SamplerConfig(), FPS, width=W)
    log(f"[stage2] card {len(dense_events)} events, CPU plain {len(plain)} events "
        f"({time.time() - t0:.1f} s)")
    if len(dense_events) == 0 or dense_events.tobytes() != plain.tobytes():
        raise AssertionError("stage 2 on the card differs from the plain path")

    kernels = []
    for name, (src, rep) in KERNELS.items():
        r = results[TIMED_CASE[name]]
        path = KERNEL_PATH[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": counted.by_path[path][name], "launches_path": path,
                        "launches_by_path": {p: c[name] for p, c in counted.by_path.items()
                                             if c[name]},
                        "max_abs_err": errs[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r.get("bound_by", "bytes"),
                        "library_ms": r.get("library_ms"),
                        **{k: r[k] for k in ("device_ms", "plain_device_ms", "k",
                                             "k_lo_device_ms", "el_ops_per_s",
                                             "issue_el_ops_per_s", "bytes_per_s") if k in r}})
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "stage2_roofline": roofline_rates,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


COMPARE_CONV = """
import json, sys, torch, numpy
sys.path.insert(0, ".")
import chip_smoke
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
results, errs = chip_smoke.conv_kernels_phase(torch, numpy, torch.device("cuda"))
print("RESULT " + json.dumps(results))
"""


def compare_conv(trees):
    """Phase 8 of each tree's chip_smoke.py, in turns, one process each."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", COMPARE_CONV], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"phase 8 of {tree} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.split("RESULT ", 1)[1])
        log(f"[compare-conv] {tree}: " + ", ".join(
            f"{label} kernel {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, cuDNN "
            f"{r['library_ms']:.4f})" for label, r in sorted(res.items())) + f" [{smi}]")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare-conv"]:
        compare_conv(sys.argv[2:])
    else:
        main()
