#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`v2ce_toolbox_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero before the result lines:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the CUDA kernels from csrc/ (nvcc, sm_90a), timed;
  3. each kernel (K1 gen_compact, K2 compact_rows, K3 merge_sorted_rows)
     against its plain-torch twin on the card, on the inputs the stage-2
     path gives it for synthetic (24, 2, 10, 260, 346) voxels at two
     densities; outputs must be identical; median CUDA-event times of
     kernel and twin at the dense setting;
  4. the center-mode CLI (`cli.main`) on a 33-frame 260x346 clip with the
     full-width model on seeded random weights: stage-1 ms/window, stage-2
     ms/chunk, events, frames/s of the median of N_CLI warm runs; launch
     counters reset just before the first of them must all have moved, and
     the npz must hold EVENT_DTYPE records inside the frame, time-sorted;
  5. stage 1 on the card against the CPU: the full-width model on one
     16-frame 64x96 window, finite, within STAGE1_REL_TOL of the CPU
     output relative to its largest value;
  6. stage 2 alone on the dense synthetic voxels: the kernel path on the
     card against the plain path on the CPU with the same draws,
     byte-identical decoded events, and events > 0.
The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")      # the clip and the CLI outputs
N_TIMED = 15
N_CLI = 3
STAGE1_REL_TOL = 1e-4


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
        assert x.shape == y.shape and x.dtype == y.dtype, (x.shape, y.shape)
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def cuda_ms(fn, torch):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_pair(kernel, plain, torch):
    """Median ms of kernel and plain over N_TIMED runs, in turns."""
    kernel(), plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(N_TIMED):
        order = [(tp, plain), (tk, kernel)] if i % 2 else [(tk, kernel), (tp, plain)]
        for acc, fn in order:
            acc.append(cuda_ms(fn, torch))
    return statistics.median(tk), statistics.median(tp)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    import numpy as np

    from v2ce_toolbox_tpu_torch import cli, ops
    from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.ops import _cuda, compact, gen, ldati
    from v2ce_toolbox_tpu_torch.pipeline import driver
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
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
    scfg = SamplerConfig()
    fps, f, h, w = 30, 24, 260, 346
    offsets = torch.from_numpy((np.arange(f) / fps * 1e6).astype(np.int32)).to(dev)
    vb = 18
    timings = {}
    dense_v = dense_events = None
    for density, scale in [(0.05, 1.5), (0.3, 5.0)]:
        g = torch.Generator(device=dev).manual_seed(1234)
        v = ((torch.rand((f, 2, 10, h, w), generator=g, device=dev) < density)
             * torch.rand((f, 2, 10, h, w), generator=g, device=dev) * scale).contiguous()
        draw = ldati.make_draw(0, 0, dev)
        k2_calls, k3_calls = [], []
        with record_calls([ldati, driver], "compact_rows", k2_calls), \
                record_calls([driver], "merge_sorted_rows", k3_calls):
            events = driver._fetch_chunk_events_fused(v, draw, offsets, f, scfg, fps,
                                                      width=w)
        torch.cuda.synchronize()
        kw1 = dict(fps=fps, mepv=scfg.max_events_per_voxel, vox_bits=vb,
                   cap_bin=scfg.cap_bin)
        err1 = max_abs_err(gen.gen_compact(v, **kw1), gen.gen_compact_torch(v, **kw1))
        errs = {"gen_compact": err1, "compact_rows": 0, "merge_sorted_rows": 0}
        for name, calls, kernel, plain in [
                ("compact_rows", k2_calls, compact.compact_rows, compact.compact_rows_torch),
                ("merge_sorted_rows", k3_calls, compact.merge_sorted_rows,
                 compact.merge_sorted_rows_torch)]:
            for args, kwargs in calls:
                errs[name] = max(errs[name], max_abs_err(kernel(*args, **kwargs),
                                                         plain(*args, **kwargs)))
        shapes = {"compact_rows": [(tuple(a[0].shape), kw) for a, kw in k2_calls],
                  "merge_sorted_rows": [(tuple(a[0].shape), kw) for a, kw in k3_calls]}
        log(f"[kernels] density {density} x{scale}: events {len(events)}, "
            f"max_abs_err {errs}, K2 calls {shapes['compact_rows']}, "
            f"K3 calls {shapes['merge_sorted_rows']}")
        for name, e in errs.items():
            if e != 0:
                raise AssertionError(f"{name} differs from its plain twin: {e}")
        if density == 0.3:
            dense_v, dense_events, dense_draw = v, events, draw
            tk, tp = time_pair(lambda: gen.gen_compact(v, **kw1),
                               lambda: gen.gen_compact_torch(v, **kw1), torch)
            timings["gen_compact"] = (tk, tp, errs["gen_compact"])
            for name, calls, kernel, plain in [
                    ("compact_rows", k2_calls, compact.compact_rows,
                     compact.compact_rows_torch),
                    ("merge_sorted_rows", k3_calls, compact.merge_sorted_rows,
                     compact.merge_sorted_rows_torch)]:
                tk = tp = 0.0
                for args, kwargs in calls:
                    a, b = time_pair(lambda: kernel(*args, **kwargs),
                                     lambda: plain(*args, **kwargs), torch)
                    log(f"[time] {name} {tuple(args[0].shape)} {kwargs}: "
                        f"kernel {a:.4f} ms, plain {b:.4f} ms")
                    tk, tp = tk + a, tp + b
                timings[name] = (tk, tp, errs[name])
            log(f"[time] gen_compact {tuple(v.shape)}: kernel {timings['gen_compact'][0]:.4f}"
                f" ms, plain {timings['gen_compact'][1]:.4f} ms")

    # 4. the CLI main path, counted
    import cv2

    from tools.make_test_video import make_frames

    os.makedirs(OUT, exist_ok=True)
    clip = os.path.join(OUT, "clip.mp4")
    video = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (346, 260))
    for fr in make_frames(33, 260, 346):
        video.write(cv2.cvtColor(fr, cv2.COLOR_GRAY2BGR))
    video.release()
    argv = ["-i", clip, "-o", OUT, "-m", os.path.join(OUT, "absent.pt"),
            "--device", "cuda", "--seed", "0", "-l", "warning"]
    cli.main(argv)                                   # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    ops.reset_launches()
    result = cli.main(argv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"[cli] launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the CLI run never launched {name}")
    ev = np.load(result["event_stream_path"])["event_stream"]
    if ev.dtype != EVENT_DTYPE:
        raise AssertionError(f"npz dtype {ev.dtype} != {EVENT_DTYPE}")
    if len(ev) and not (ev["x"].min() >= 0 and ev["x"].max() < 346
                        and ev["y"].min() >= 0 and ev["y"].max() < 260
                        and np.all(np.diff(ev["timestamp"]) >= 0)
                        and ev["timestamp"].min() >= 0
                        and ev["timestamp"].max() < 32 / 30 * 1e6):
        raise AssertionError("CLI events outside the 260x346 frame or unsorted")
    # the host shares its cores: report the run with the median wall time
    runs = [result] + [cli.main(argv) for _ in range(N_CLI - 1)]
    if len({r["num_events"] for r in runs}) != 1:
        raise AssertionError("repeated CLI runs gave different event counts")
    result = sorted(runs, key=lambda r: r["wall_time_s"])[N_CLI // 2]
    t = result["timings"]
    log(f"[cli] stage-1 {t['stage1_s'] / t['windows'] * 1e3:.2f} ms/window "
        f"({t['windows']} windows), stage-2 {t['stage2_s'] / t['chunks'] * 1e3:.2f} "
        f"ms/chunk ({t['chunks']} chunks), events {result['num_events']}, "
        f"{result['num_frames'] / result['wall_time_s']:.2f} frames/s "
        f"({result['num_frames']} frames in {result['wall_time_s']:.3f} s) [{smi}]")

    # 5. stage 1 on the card against the CPU: the full-width model, seeded
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

    # 6. stage 2 alone: kernel path (card) against the plain path (CPU)
    t0 = time.time()
    plain = driver._fetch_chunk_events_fused(
        dense_v.cpu(), lambda j, shape: dense_draw(j, shape).cpu(), offsets.cpu(), f,
        scfg, fps, width=w)
    log(f"[stage2] card {len(dense_events)} events, CPU plain {len(plain)} events "
        f"({time.time() - t0:.1f} s)")
    if len(dense_events) == 0 or dense_events.tobytes() != plain.tobytes():
        raise AssertionError("stage 2 on the card differs from the plain path")

    sources = {"gen_compact": ("v2ce_toolbox_tpu_torch/csrc/gen_compact.cu",
                               "v2ce_toolbox_tpu/ops/gen_pallas.py:315"),
               "compact_rows": ("v2ce_toolbox_tpu_torch/csrc/compact_rows.cu",
                                "v2ce_toolbox_tpu/ops/compact_pallas.py:226"),
               "merge_sorted_rows": ("v2ce_toolbox_tpu_torch/csrc/merge_rows.cu",
                                     "v2ce_toolbox_tpu/ops/compact_pallas.py:492")}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": timings[name][2],
                "ms": timings[name][0], "plain_ms": timings[name][1]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
