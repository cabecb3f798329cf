"""The stage-2 probes of the JAX package's `tools/perf_probe.py`, on the
port: the LDATI sampler's phases, the stream flatten and the fused wire
path, each timed alone on the card, and the yardsticks around them (library
sorts and gathers, the matmul, copy and cuDNN conv rooflines). `perf_probe`
registers them under their JAX names (`PROBES` below) and runs them.

Each probe keeps the JAX probe's shapes as keyword defaults and prints its
line labels; a label that names the XLA chain ("xla relocate+slope+pack")
names the port's unfused torch chain of the same steps. The JAX harness
timed one jit; here each step is eager torch, so a line that measured XLA's
dead-code elimination says what eager torch ran instead. The draws are
torch's Philox (`ldati.make_draw`), so counts match the JAX probes only in
distribution. `KERNELS` names the kernels each probe must launch on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

VOXELS = (16, 2, 10, 260, 346)       # one 16-frame 260x346 window of voxels
FPS = 30

# probe -> the port kernels it launches on the card
KERNELS = {
    "sampler": ("gen_compact", "compact_rows", "merge_sorted_rows"),
    "sort": (),
    "sampler_phases": ("compact_rows", "merge_sorted_rows"),
    "gen": ("gen_pack",),
    "flatten": ("compact_rows", "compact_rows_window", "append_rows"),
    "sampler_strategies": ("gen_compact", "compact_rows", "merge_sorted_rows"),
    "gen_compact": ("gen_compact", "gen_pack", "compact_rows"),
    "fused_pipeline": ("gen_compact", "compact_rows", "merge_sorted_rows", "append_rows"),
    "fused_phases": ("gen_compact", "compact_rows", "merge_sorted_rows"),
    "bf16_fidelity": ("gen_compact", "compact_rows", "merge_sorted_rows"),
    "roofline": (),
}


def _timed(fn, args, graph: bool = False) -> float:
    """`perf_probe.timed_loop` with the harness's N_ITERS as it stands at
    the call (a caller may lower it)."""
    from v2ce_toolbox_tpu_torch.tools import perf_probe

    return perf_probe.timed_loop(fn, args, perf_probe.N_ITERS, graph)


def _failed(label: str, e: Exception, n: int = 200) -> None:
    from v2ce_toolbox_tpu_torch.tools import perf_probe

    perf_probe._failed(label, e, n)


def sample(t: torch.Tensor) -> torch.Tensor:
    """A thin slice of t (index 0 of its longest axis) for the timing loop's
    checksum: the call has computed all of t, and the checksum's own passes
    over a large output (its cast to f64 and sum) stay out of the time."""
    axis = max(range(t.dim()), key=lambda d: t.shape[d])
    return t.narrow(axis, 0, 1)


def voxels(dev, shape=VOXELS, seed: int = 0) -> torch.Tensor:
    """The JAX probes' synthetic voxels: 10% of the voxels nonzero, U[0, 4)."""
    rng = np.random.RandomState(seed)
    v = (rng.rand(*shape) < 0.1).astype(np.float32) * rng.rand(*shape).astype(np.float32) * 4
    return torch.from_numpy(v).to(dev)


def offsets(f: int, dev) -> torch.Tensor:
    """Each frame's start in µs within a chunk at 30 fps."""
    return torch.from_numpy((np.arange(f) / FPS * 1e6).astype(np.int32)).to(dev)


def _grid(v: torch.Tensor) -> torch.Tensor:
    """The pre-ordered grid of `ldati.sample_events`: (F, P, C, H, W) ->
    (F, C, P_flipped*H, W), one transpose of the input."""
    f, p, c, h, w = v.shape
    return torch.flip(v, [1]).transpose(1, 2).reshape(f, c, p * h, w)


def phase_gen(v: torch.Tensor, fps: int = FPS, mepv: int = 32):
    """`sampler_phases`' generation: relocate, slope fit and key packing on
    the pre-ordered grid, unfused. Returns (keys (F, 9, P*H*W) int32, k)."""
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID
    from v2ce_toolbox_tpu_torch.ops.ldati import relocate_counts, slope_params, vox_bits_of

    f, p, c, h, w = v.shape
    cb, seg = c - 1, p * h * w
    counts, tendency = relocate_counts(_grid(v))
    k, _ = slope_params(counts.float(), fps)
    rel = (tendency * 3703).to(torch.int32)
    emit = torch.clamp(counts, max=mepv)
    vox = torch.arange(seg, dtype=torch.int32, device=v.device)
    keys = torch.where(emit.reshape(f, cb, seg) > 0,
                       (rel.reshape(f, cb, seg) << vox_bits_of(p, h, w)) | vox, INVALID)
    return keys, k


def gen_chain(v: torch.Tensor, fps: int = FPS, mepv: int = 16):
    """`gen`'s unfused chain, the steps K4 `gen_pack` fuses: relocate,
    slope fit, the chain timestamps and the key and payload packing, each
    materialised. Returns (keys, kx, emit), each (F, 9, P*H, W) int32, the
    keys' voxel field the within-bin voxel id (the JAX probe packs a
    constant there; the work is the same)."""
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID
    from v2ce_toolbox_tpu_torch.ops.ldati import f32, relocate_counts, slope_params, vox_bits_of

    f, p, c, h, w = v.shape
    cb = c - 1
    counts, tendency = relocate_counts(_grid(v))
    k, _ = slope_params(counts.float(), fps)
    is_chain = counts == 1
    emit = torch.clamp(torch.where(is_chain, 1, torch.clamp(counts, max=mepv)), min=0)
    ts_us = ((tendency / f32(fps, v.device) / f32(cb, v.device)) * 1e6).to(torch.int32)
    rel = torch.where(is_chain, torch.clamp(ts_us, 0, 1 << 12), 0)
    vox = torch.arange(p * h * w, dtype=torch.int32, device=v.device).view(p * h, w)
    keys = torch.where(emit > 0, (rel << vox_bits_of(p, h, w)) | vox, INVALID)
    extra = torch.clamp(torch.clamp(counts - 1, min=0), max=min(mepv - 1, 255))
    kx = (k.view(torch.int32) & ~0xFF) | extra
    return keys, kx, emit


def probe_sampler(dev, shape=VOXELS):
    """`ldati.sample_events` (the v3 core: K1, K2, K3) on one window of
    synthetic voxels, the whole stream consumed, then only its counts."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_events

    scfg, draw, f = SamplerConfig(), make_draw(0, 0, dev), shape[0]
    v = voxels(dev, shape)

    def fn_full(args):
        s = sample_events(args[0], draw, scfg)
        return (s.count, (s.t_us.long() % 97).sum(), s.x.long().sum(), s.y.long().sum())

    def fn_count(args):
        return sample_events(args[0], draw, scfg).count

    full = _timed(fn_full, (v,))
    print(f"sampler {f} frames (full stream): {full*1e3:.2f} ms ({f/full:.1f} fps)", flush=True)
    count = _timed(fn_count, (v,))
    print(f"sampler {f} frames (count only - sort DCE'd): {count*1e3:.2f} ms (eager torch "
          "runs the whole stream, sort included: nothing is dead-code eliminated)", flush=True)
    return {"full_s": full, "count_only_s": count}


SORT_NS = (9 * (1 << 14), 9 * (1 << 15), 9 * (1 << 17), 9 * 229376)


def probe_sort(dev, ns=SORT_NS, rows=16, top=1 << 12, gathers=(1 << 16, 1 << 19)):
    """Library primitives at the sampler's scale, (16, n): `torch.sort`,
    the key-value form (the keys sorted, the values gathered by the
    permutation), row sorts of the (144, n/9) reshape, `torch.topk` of the
    16-wide block maxima and `torch.gather` of 64k and 512k indices.
    Yardsticks, not kernel ports."""
    rng = np.random.RandomState(0)
    res = {}
    for n in ns:
        keys = torch.from_numpy(rng.randint(0, 1 << 30, (rows, n), np.int32)).to(dev)
        vals = torch.from_numpy(rng.randint(0, 1 << 20, (rows, n), np.int32)).to(dev)

        def kv_sort(args):
            kk, vv = args
            s, perm = torch.sort(kk, dim=1)
            return s, torch.gather(vv, 1, perm)

        def rows9(args, n=n):
            return torch.sort(args[0].reshape(rows * 9, n // 9), dim=1).values

        def rows9_kv(args, n=n):
            kk, vv = args
            s, perm = torch.sort(kk.reshape(rows * 9, n // 9), dim=1)
            return s, torch.gather(vv.reshape(rows * 9, n // 9), 1, perm)

        def topk_blocks(args, n=n):
            return torch.topk(args[0].reshape(rows, n // 16, 16).amax(dim=2), top, dim=1).values

        def gather(args, g, n=n):
            kk, vv = args
            return torch.gather(kk, 1, (vv[:, :g].abs() % n).long())

        cases = [("kv_sort", kv_sort), ("rows9_sort", rows9), ("rows9_kv", rows9_kv),
                 (f"topk{top >> 10}k_of_blockmax", topk_blocks)]
        cases += [(f"gather_{g >> 10}k", lambda a, g=g: gather(a, g)) for g in gathers]
        for label, fn in cases:
            try:
                dt = _timed(fn, (keys, vals))
                res[(n, label)] = dt
                print(f"n={n/1e6:.2f}M x{rows} {label}: {dt*1e3:.2f} ms  "
                      f"({n*rows/dt/1e9:.2f} Gelem/s)", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"n={n/1e6:.2f}M x{rows} {label}", e)
        del keys, vals
    return res


def probe_sampler_phases(dev, shape=VOXELS, sort_w=16384, merge_cap=1 << 19):
    """The v3 sampler's phases, each timed alone: the unfused generation
    (`phase_gen`), the chain compaction (K2 place, one payload), the
    per-bin sort (`torch.sort` at (144, 16384)) and the frame merge (K3,
    144 x 16384 into 16 frames). The merge's rows are sorted, INVALID last:
    K3 reads only rows whose valid keys form a prefix."""
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows, merge_sorted_rows

    rng = np.random.RandomState(0)
    f, p, c, h, w = shape
    cb, seg = c - 1, p * h * w
    res = {}
    v = voxels(dev, shape, seed=0)

    def gen(args):
        keys, k = phase_gen(args[0])
        return keys.long().sum(), k.sum()

    res["gen_s"] = _timed(gen, (v,))
    print(f"phase gen(pre-ordered relocate+slope+pack): {res['gen_s']*1e3:.2f} ms", flush=True)
    del v

    keys0 = np.where(rng.rand(f * cb, seg) < 0.15, rng.randint(0, 1 << 30, (f * cb, seg)),
                     INVALID).astype(np.int32)
    kx = rng.randint(0, 1 << 30, (f * cb, seg)).astype(np.int32)

    def chain(args):
        o, (op,), kc, _ = compact_rows(args[0], [args[1]], cap=1 << 14, chunk=16384,
                                       algo="place")
        return o[:, ::255].long().sum(), (op[:, ::255] % 31).sum(), kc.sum()

    res["chain_s"] = _timed(chain, (torch.from_numpy(keys0).to(dev),
                                    torch.from_numpy(kx).to(dev)), graph=True)
    print(f"phase chain compaction (place, 1 payload): {res['chain_s']*1e3:.2f} ms", flush=True)
    del keys0, kx

    sort_in = torch.from_numpy(rng.randint(0, 1 << 30, (f * cb, sort_w), np.int32)).to(dev)
    res["sort_s"] = _timed(lambda a: torch.sort(a[0], dim=1).values, (sort_in,), graph=True)
    print(f"phase per-bin sort ({f * cb}x{sort_w >> 10}k post-sort_cap): "
          f"{res['sort_s']*1e3:.2f} ms", flush=True)
    del sort_in

    mrow = np.sort(np.where(rng.rand(f * cb, sort_w) < 0.3,
                            rng.randint(0, 1 << 30, (f * cb, sort_w)), INVALID).astype(np.int32),
                   axis=1)
    valid = mrow != INVALID
    if not (valid[:, :-1] >= valid[:, 1:]).all():
        raise AssertionError("sampler_phases: the merge's rows are not prefix-packed")
    merge_px = rng.randint(0, 1 << 20, (f * cb, sort_w)).astype(np.int32)

    def merge(args):
        o, (op,), kc, _ = merge_sorted_rows(args[0], [args[1]], nb=cb, cap=merge_cap)
        return o[:, ::255].long().sum(), (op[:, ::255] % 31).sum(), kc.sum()

    res["merge_s"] = _timed(merge, (torch.from_numpy(mrow).to(dev),
                                    torch.from_numpy(merge_px).to(dev)), graph=True)
    print(f"phase frame merge (append, {f * cb}x{sort_w >> 10}k -> {f} frames): "
          f"{res['merge_s']*1e3:.2f} ms", flush=True)
    return res


def probe_gen(dev, shape=VOXELS, mepv=16):
    """The generation phase: the unfused chain (`gen_chain`) against K4
    `gen_pack`, which fuses it."""
    from v2ce_toolbox_tpu_torch.ops.gen import gen_pack
    from v2ce_toolbox_tpu_torch.ops.ldati import vox_bits_of

    _, p, _, h, w = shape
    v = voxels(dev, shape)

    def unfused(args):
        keys, kx, emit = gen_chain(args[0], mepv=mepv)
        return keys[..., ::7].long().sum() + kx[..., ::7].long().sum(), emit.sum()

    def fused(args):
        keys, kx, emit, drop = gen_pack(args[0], fps=FPS, t0=0.0, strategy="slope", mepv=mepv,
                                        vox_bits=vox_bits_of(p, h, w))
        return keys[:, ::7].long().sum() + kx[:, ::7].long().sum(), emit.sum() + drop.sum()

    res = {}
    for name, fn in [("xla relocate+slope+pack", unfused), ("fused gen_pack kernel", fused)]:
        res[name] = _timed(fn, (v,), graph=name.startswith("fused"))
        print(f"gen [{name}]: {res[name]*1e3:.2f} ms", flush=True)
    return res


def probe_flatten(dev, frames=16, cap=1 << 19, per_frame=74_000, span_us=33_333,
                  side_cap=1 << 17):
    """The EventStream route's device flatten at synthetic-dense load
    (74,000 events a frame): its main pass, K2 place on one 8.4M-slot row
    against K5 append on the 16 frame rows; its side pass, K2w (window,
    chunk 2048) against K2 place (chunk 8192); and the whole
    `driver._flatten_chunk_stream` (K5, then K2 on the side list)."""
    from v2ce_toolbox_tpu_torch.events import EventStream
    from v2ce_toolbox_tpu_torch.ops.compact import INVALID, append_rows, compact_rows
    from v2ce_toolbox_tpu_torch.pipeline.driver import _flatten_chunk_stream

    rng = np.random.RandomState(0)
    counts = np.full(frames, per_frame, np.int32)
    t = np.sort(rng.randint(0, span_us, (frames, cap)).astype(np.int32), 1)
    slot = np.arange(cap)[None]
    keys = torch.from_numpy(np.where(slot < counts[:, None], t, INVALID).astype(np.int32)).to(dev)
    pay = torch.from_numpy(np.where(slot < counts[:, None], rng.randint(0, 346, (frames, cap)),
                                    0).astype(np.int32)).to(dev)
    del t
    width = frames * cap
    res = {}

    def main_place(args):
        kk, px = args
        o, _, kc, _ = compact_rows(kk.reshape(1, width), [px.reshape(1, width)], cap=width,
                                   chunk=8192, algo="place")
        return o[:, ::255].long().sum(), kc.sum()

    def main_append(args):
        o, _, kc, _ = append_rows(args[0], [args[1]], cap=width, chunk=8192)
        return o[:, ::255].long().sum(), kc.sum()

    for name, fn in [(f"place 1x{width / 1e6:.1f}M", main_place),
                     (f"append {frames}x{cap >> 10}k", main_append)]:
        res[name] = _timed(fn, (keys, pay), graph=True)
        print(f"flatten main pass [{name}]: {res[name]*1e3:.2f} ms", flush=True)

    # the side pass at the stream's width: ~1% markers
    out_k = torch.from_numpy(np.sort(rng.randint(0, 1 << 29, width)).astype(np.int32)).to(dev)
    is_exc = torch.from_numpy(rng.rand(width) < 0.01).to(dev)
    idx = torch.arange(width, dtype=torch.int32, device=dev)
    side_in = torch.where(is_exc, idx, INVALID)
    del is_exc, idx
    for name, kw in [("window-2048", dict(chunk=2048)),
                     ("place-8192", dict(chunk=8192, algo="place"))]:
        def side(args, kw=kw):
            _, (sk,), ns, _ = compact_rows(args[0][None], [args[1][None]], cap=side_cap, **kw)
            return sk[:, ::255].long().sum(), ns.sum()

        res[name] = _timed(side, (side_in, out_k), graph=True)
        print(f"flatten side pass [{name}]: {res[name]*1e3:.2f} ms", flush=True)
    del out_k, side_in

    zeros = torch.zeros((frames, cap), dtype=torch.int16, device=dev)
    stream = EventStream(t_us=keys, x=pay.to(torch.int16), y=zeros, p=zeros.to(torch.int8),
                         count=torch.from_numpy(counts).to(dev),
                         dropped=torch.zeros(frames, dtype=torch.int32, device=dev))
    offs = offsets(frames, dev)

    def full(args):
        words, kept, side_key, n_side, side_total = _flatten_chunk_stream(
            stream._replace(t_us=args[0]), offs, frames)
        return (words % 97).sum() + kept + (side_key % 83).sum() + n_side + side_total

    res["full"] = _timed(full, (keys,))
    print(f"flatten full (_flatten_chunk_stream): {res['full']*1e3:.2f} ms", flush=True)
    return res


def probe_sampler_strategies(dev, shape=VOXELS, strategies=("none", "slope", "random")):
    """`sample_events` on one window for each additional-events strategy:
    'none' and 'slope' on K1, 'random' on the grid path (K2, the two-word
    sort) and K3."""
    import dataclasses

    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_events

    f, p, c, h, w = shape
    rng = np.random.RandomState(0)
    cl = (f, h, w, p * c)
    x = torch.from_numpy((rng.rand(*cl) < 0.1).astype(np.float32)
                         * rng.rand(*cl).astype(np.float32) * 4).to(dev)
    draw = make_draw(0, 0, dev)
    res = {}
    for strategy in strategies:
        scfg = dataclasses.replace(SamplerConfig(), additional_events_strategy=strategy)

        def fn(args, scfg=scfg):
            v = args[0].permute(0, 3, 1, 2).reshape(f, p, c, h, w).contiguous()
            s = sample_events(v, draw, scfg)
            return s.count.sum() + (s.t_us.long() % 97).sum() + s.x.long().sum()

        res[strategy] = _timed(fn, (x,))
        print(f"sampler strategy={strategy}: {res[strategy]*1e3:.2f} ms / {f} frames",
              flush=True)
    return res


def fidelity_metrics(p: torch.Tensor, g: torch.Tensor) -> dict:
    """`bf16_fidelity`'s stage-1 quality numbers of a prediction p against
    g (the f32 forward as ground truth), channels-last voxels, from
    `train/metrics`."""
    from v2ce_toolbox_tpu_torch.train import metrics as tm

    return {"mae": float((p - g).abs().mean()), "f32_mean": float(g.abs().mean()),
            "binary_match_raw": float(tm.binary_match(p, g, "raw")),
            "f1_sum_c": float(tm.binary_match_f1(p, g, "sum_c")),
            "pool_mse_k2": float(tm.pool_mse(p, g, 2))}


def stream_stats(t_a: np.ndarray, t_b: np.ndarray) -> dict:
    """Event counts, their ratio b/a and the two-sample KS distance of the
    timestamps of two streams."""
    n_a, n_b = len(t_a), len(t_b)
    both = np.sort(np.concatenate([t_a, t_b]))
    cdf_a = np.searchsorted(np.sort(t_a), both, side="right") / max(n_a, 1)
    cdf_b = np.searchsorted(np.sort(t_b), both, side="right") / max(n_b, 1)
    return {"n_f32": n_a, "n_bf16": n_b, "count_ratio": n_b / max(n_a, 1),
            "ks": float(np.abs(cdf_a - cdf_b).max())}


def _model(dev, model_kw, state=None, **cfg):
    """A V2ce3d of ModelConfig(**model_kw, **cfg) in eval mode on dev, from
    `state` or the seeded random weights (seed 0)."""
    from v2ce_toolbox_tpu_torch.config import ModelConfig
    from v2ce_toolbox_tpu_torch.models import V2ce3d
    from v2ce_toolbox_tpu_torch.utils.weights import init_weights

    model = V2ce3d(ModelConfig(**dict(model_kw or {}, **cfg)))
    if state is None:
        init_weights(model, 0)
    else:
        model.load_state_dict(state)
    return model.to(dev).eval()


def probe_bf16_fidelity(dev, seq_len=16, h=260, w=346, model_kw=None):
    """The bf16 inference configuration against the f32 one on the same
    seeded weights and frames: the voxel MAE and `train/metrics`'
    BinaryMatch, F1 and PoolMSE (the f32 forward as ground truth), then the
    LDATI streams of both from one draw, `make_draw(7, ...)`: their event
    counts, count ratio and timestamp KS."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_events
    from v2ce_toolbox_tpu_torch.pipeline.preprocess import normalize_pairs

    scfg = SamplerConfig()
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.rand(1, seq_len + 1, h, w).astype(np.float32)).to(dev)
    units = normalize_pairs(frames)
    preds, state = {}, None
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = _model(dev, model_kw, state, compute_dtype=dt)
        state = model.state_dict()
        with torch.no_grad():
            preds[name] = model(units).float()
        del model
    m = fidelity_metrics(preds["bf16"], preds["f32"])
    print(f"bf16_fidelity voxel MAE {m['mae']:.3e} (f32 mean {m['f32_mean']:.3e}); "
          f"BinaryMatch raw {m['binary_match_raw']:.6f}  F1 sum_c {m['f1_sum_c']:.6f}  "
          f"PoolMSE k2 {m['pool_mse_k2']:.3e}", flush=True)

    streams = {}
    for name, pred in preds.items():
        v = pred[0].permute(0, 3, 1, 2).reshape(seq_len, 2, 10, h, w).contiguous()
        s = sample_events(v, make_draw(7, 0, dev), scfg)
        cnt = s.count.cpu().numpy()
        t_us = s.t_us.cpu().numpy()
        streams[name] = np.concatenate([t_us[i, :cnt[i]] for i in range(seq_len)])
    st = stream_stats(streams["f32"], streams["bf16"])
    print(f"bf16_fidelity events f32 {st['n_f32']}  bf16 {st['n_bf16']}  "
          f"count ratio {st['count_ratio']:.5f}  timestamp KS {st['ks']:.5f}", flush=True)
    return {**m, **st}


def probe_fused_pipeline(dev, shape=VOXELS):
    """The fused sampler and wire path (`sample_rows` then
    `driver._flatten_rows`) against the unfused chain (`sample_events`,
    per-frame buffers, `driver._flatten_chunk_stream`) on one window at
    synthetic-dense load. Both stop on the device: no fetch, no decode."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_events, sample_rows
    from v2ce_toolbox_tpu_torch.pipeline.driver import _flatten_chunk_stream, _flatten_rows

    f, _, _, h, w = shape
    v = voxels(dev, shape)
    scfg, draw, offs = SamplerConfig(), make_draw(0, 0, dev), offsets(f, dev)

    def unfused(args):
        s = sample_events(args[0], draw, scfg)
        words, kept, side_key, n_side, side_total = _flatten_chunk_stream(s, offs, f)
        return ((words % 97).sum() + (side_key % 83).sum() + n_side + side_total + kept
                + s.dropped.sum())

    def fused(args):
        words, kept, side_key, n_side, side_total, dropped = _flatten_rows(
            *sample_rows(args[0], draw, scfg), offs, h=h, w=w, capacity=scfg.event_capacity,
            frames=f, fps=FPS)
        return ((words % 97).sum() + (side_key % 83).sum() + n_side + side_total + kept
                + dropped.sum())

    res = {}
    for name, fn in [("unfused (r4 chain)", unfused), ("fused", fused)]:
        res[name] = _timed(fn, (v,))
        print(f"sampler+flatten [{name}]: {res[name]*1e3:.2f} ms", flush=True)
    return res


def fused_phase_steps(v: torch.Tensor, draw, scfg, offsets_us: torch.Tensor) -> dict:
    """The cumulative steps of the fused wire path on voxels v, each a call
    returning its raw outputs: the sampler's rows, + the wire prep
    (`driver._wire_rows`: payload, delta, records and side candidates),
    + the merge (`driver._merge_wire`: words, kept), + the side list (the
    whole `driver._flatten_rows`)."""
    from v2ce_toolbox_tpu_torch.ops.ldati import sample_rows
    from v2ce_toolbox_tpu_torch.pipeline import driver

    f, _, _, h, w = v.shape
    kw = dict(h=h, w=w, capacity=scfg.event_capacity, frames=f, fps=scfg.fps)

    def rows():
        return sample_rows(v, draw, scfg)

    def wire():
        return driver._wire_rows(*rows(), offsets_us, **kw)

    def merge():
        valid, t_abs, recs, _, _ = wire()
        return driver._merge_wire(valid, t_abs, recs, h=h, w=w)

    def side():
        return driver._flatten_rows(*rows(), offsets_us, **kw)

    return {"rows only (sampler core)": rows, "+ wire prep": wire,
            "+ merge (no side)": merge, "+ merge + side": side}


def _fold(out):
    """A cheap checksum of a step's outputs: every 255th element of each
    2-D output, the rest whole."""
    acc = torch.zeros((), dtype=torch.int64, device=out[0].device)
    for t in out:
        t = t[:, ::255] if t.dim() == 2 else t
        acc = acc + (t.long() % 97).sum()
    return acc


def probe_fused_phases(dev, shape=VOXELS):
    """`driver._flatten_rows` taken apart (`fused_phase_steps`): each
    cumulative step timed alone, so a cost localizes."""
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw

    v = voxels(dev, shape)
    scfg, offs = SamplerConfig(), offsets(shape[0], dev)
    res = {}
    for name, step in fused_phase_steps(v, make_draw(0, 0, dev), scfg, offs).items():
        res[name] = _timed(lambda a, step=step: _fold(step()), (v,))
        print(f"fused phase [{name}]: {res[name]*1e3:.2f} ms", flush=True)
    return res


def probe_gen_compact(dev, shape=VOXELS):
    """K1 `gen_compact` against the chain it fuses, K4 `gen_pack` then K2
    `compact_rows` (place), alone; then the sampler's rows path
    (`ldati.sample_rows`) with `use_gen_compact` False (K4 + K2) and True
    (K1)."""
    import dataclasses

    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.compact import compact_rows
    from v2ce_toolbox_tpu_torch.ops.gen import gen_compact, gen_pack
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_rows, vox_bits_of

    _, p, _, h, w = shape
    v = voxels(dev, shape)
    kw = dict(fps=FPS, t0=0.0, strategy="slope", mepv=32, vox_bits=vox_bits_of(p, h, w))

    def fold(ck, ckx, *counts):
        return ((ck[:, ::127] % 97).sum() + (ckx[:, ::127] % 31).sum(),
                *(c.sum() for c in counts))

    def unfused(args):
        keys, kx, emit, drop = gen_pack(args[0], **kw)
        ck, (ckx,), kept, tot = compact_rows(keys, [kx], cap=1 << 14, chunk=16384, algo="place")
        return fold(ck, ckx, kept, tot, emit, drop)

    def fused(args):
        return fold(*gen_compact(args[0], cap_bin=1 << 14, **kw))

    res = {}
    for name, fn in (("gen_pack + compact_rows", unfused), ("gen_compact (fused)", fused)):
        res[name] = _timed(fn, (v,), graph=True)
        print(f"{name}: {res[name]*1e3:.2f} ms", flush=True)

    draw = make_draw(0, 0, dev)
    for flag in (False, True):
        scfg = dataclasses.replace(SamplerConfig(), use_gen_compact=flag)

        def rows(args, scfg=scfg):
            rel, gvox, te, cd = sample_rows(args[0], draw, scfg)
            return ((rel[:, ::255] % 97).sum() + (gvox[:, ::255] % 83).sum(), te.sum(),
                    cd.sum())

        res[f"rows use_gen_compact={flag}"] = t = _timed(rows, (v,))
        print(f"sampler rows path (use_gen_compact={flag}): {t*1e3:.2f} ms", flush=True)
    return res


ROOFLINE_LAYERS = [
    ("head", 260, 346, 2, 32, 1),
    ("enc1_c1s2", 260, 346, 32, 64, 2),
    ("enc1_c2", 130, 173, 64, 64, 1),
    ("enc2_c1s2", 130, 173, 64, 128, 2),
    ("enc2_c2", 65, 87, 128, 128, 1),
    ("enc3_c1s2", 65, 87, 128, 256, 2),
    ("enc3_c2", 33, 44, 256, 256, 1),
    ("enc4_c1s2", 33, 44, 256, 512, 2),
    ("enc4_c2", 17, 22, 512, 512, 1),
    ("botl_c", 17, 22, 512, 512, 1),
    ("dec0_c1", 33, 44, 768, 256, 1),
    ("dec0_c2", 33, 44, 256, 256, 1),
    ("dec1_c1", 65, 87, 384, 128, 1),
    ("dec1_c2", 65, 87, 128, 128, 1),
    ("dec2_c1", 130, 173, 192, 64, 1),
    ("dec2_c2", 130, 173, 64, 64, 1),
    ("dec3_c1", 260, 346, 96, 32, 1),
    ("dec3_c2", 260, 346, 32, 32, 1),
]


def rand(dev, shape, seed: int = 0, scale: float = 1.0) -> torch.Tensor:
    """U[0, scale) f32 from a seeded generator on dev: a large conv input
    made on the card, not on the host."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev) * scale


def probe_roofline(dev, mm=4096, copy_shape=(256, 1024, 1024), layers=ROOFLINE_LAYERS,
                   frames=16):
    """The card's yardsticks: `torch.matmul` at 4096^3 in bf16 and f32, a
    1 GiB read + write (`x * 1.0000001`), and every 3x3x3 layer of the
    model as `F.conv3d` (cuDNN, output in the input dtype) in f32 and bf16,
    with their sums. The f32 matmul and convs run as the caller set TF32
    (the harness's `devices:` line states it)."""
    import torch.nn.functional as F

    res = {}
    for dt_name, dt in [("bf16", torch.bfloat16), ("f32", torch.float32)]:
        a, b = rand(dev, (mm, mm), 1).to(dt), rand(dev, (mm, mm), 2).to(dt)
        t = _timed(lambda args: sample(torch.matmul(*args)), (a, b))
        res[f"matmul_{dt_name}"] = t
        print(f"matmul_{dt_name} {mm}^3: {t*1e3:.3f} ms  {2*mm**3/t/1e12:.1f} TF/s", flush=True)
        del a, b

    x = rand(dev, copy_shape)
    t = _timed(lambda args: sample(args[0] * 1.0000001), (x,))
    res["hbm_rw"] = t
    print(f"hbm_rw {x.numel() * 4 / 2**30:.0f}GiB: {t*1e3:.2f} ms  "
          f"{2*x.numel()*4/t/1e9:.0f} GB/s", flush=True)
    del x

    total = {"f32": 0.0, "bf16": 0.0}
    for name, h, w, cin, cout, s in layers:
        x = rand(dev, (1, cin, frames, h, w)).to(memory_format=torch.channels_last_3d)
        k = rand(dev, (cout, cin, 3, 3, 3), 1, 0.01).to(memory_format=torch.channels_last_3d)
        ho, wo = -(-h // s), -(-w // s)
        flops = 2 * frames * ho * wo * cin * cout * 27
        for dt_name, dt in [("f32", torch.float32), ("bf16", torch.bfloat16)]:
            def fn(args, dt=dt, s=s):
                return sample(F.conv3d(args[0].to(dt), args[1].to(dt), stride=(1, s, s),
                                       padding=1))

            try:
                t = _timed(fn, (x, k))
                total[dt_name] += t
                res[(name, dt_name)] = t
                print(f"{name} {h}x{w} {cin}->{cout}s{s} {dt_name}: {t*1e3:.2f} ms  "
                      f"{flops/t/1e12:.1f} TF/s", flush=True)
            except Exception as e:  # noqa: BLE001
                _failed(f"{name} {dt_name}", e)
        del x, k
    res["sum_f32"], res["sum_bf16"] = total["f32"], total["bf16"]
    print(f"sum of layers: f32 {total['f32']*1e3:.1f} ms, bf16 {total['bf16']*1e3:.1f} ms",
          flush=True)
    return res


PROBES = {
    "sampler": probe_sampler,
    "sort": probe_sort,
    "sampler_phases": probe_sampler_phases,
    "gen": probe_gen,
    "flatten": probe_flatten,
    "sampler_strategies": probe_sampler_strategies,
    "gen_compact": probe_gen_compact,
    "fused_pipeline": probe_fused_pipeline,
    "fused_phases": probe_fused_phases,
    "bf16_fidelity": probe_bf16_fidelity,
    "roofline": probe_roofline,
}
