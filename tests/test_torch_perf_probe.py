"""The port's probe harness (`v2ce_toolbox_tpu_torch/tools/perf_probe.py`,
with `probes_stage1` and `probes_stage2`) on the CPU at tiny shapes: each
probe runs through its kernels' plain twins, prints the JAX probe's lines
and returns finite measurements; `wino_ablate` prints FAILED only for
'noinv', as the JAX probe does, and the JAX options the port does not carry
print "not ported" or "not applicable". The probes' own re-statements of a
production step are held against that step: the unfused generation chains
against the JAX package's `relocate_counts` / `slope_params`, the fused
wire path's phases against `driver._flatten_rows`, and `bf16_fidelity`'s
metrics against the JAX `train/metrics`. Its numbers here are the CPU's."""

import math
import re

import numpy as np
import pytest
import torch

from v2ce_toolbox_tpu_torch.tools import perf_probe, probes_stage1, probes_stage2
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
VOX = (2, 2, 10, 16, 24)                       # (frames, P, bins, H, W)
SMALL = dict(h=16, w=24, frames=2, model_kw=dict(num_encoders=2, base_num_channels=4))
# the labels each probe prints (the text before the first ':') at the
# tiny shapes below
STAGE2_LABELS = {
    "sampler": ["sampler 2 frames (full stream)", "sampler 2 frames (count only - sort DCE'd)"],
    "sort": [f"n=0.01M x16 {lab}" for lab in ("kv_sort", "rows9_sort", "rows9_kv",
                                               "topk0k_of_blockmax", "gather_1k", "gather_4k")],
    "sampler_phases": ["phase gen(pre-ordered relocate+slope+pack)",
                       "phase chain compaction (place, 1 payload)",
                       "phase per-bin sort (18x0k post-sort_cap)",
                       "phase frame merge (append, 18x0k -> 2 frames)"],
    "gen": ["gen [xla relocate+slope+pack]", "gen [fused gen_pack kernel]"],
    "flatten": ["flatten main pass [place 1x0.0M]", "flatten main pass [append 2x4k]",
                "flatten side pass [window-2048]", "flatten side pass [place-8192]",
                "flatten full (_flatten_chunk_stream)"],
    "sampler_strategies": [f"sampler strategy={s}" for s in ("none", "slope", "random")],
    "gen_compact": ["gen_pack + compact_rows", "gen_compact (fused)",
                    "sampler rows path (use_gen_compact=False)",
                    "sampler rows path (use_gen_compact=True)"],
    "fused_pipeline": ["sampler+flatten [unfused (r4 chain)]", "sampler+flatten [fused]"],
    "fused_phases": [f"fused phase [{s}]" for s in ("rows only (sampler core)", "+ wire prep",
                                                    "+ merge (no side)", "+ merge + side")],
}
STAGE2_KW = {
    "sort": dict(ns=(9 * 1024,), top=256, gathers=(1 << 10, 1 << 12)),
    "sampler_phases": dict(shape=VOX, sort_w=256, merge_cap=1024),
    "flatten": dict(frames=2, cap=1 << 12, per_frame=1000, side_cap=1 << 10),
}
MODEL_LABELS = {"model": "model", "model_pad": "model_pad384", "model_bf16": "model_bf16",
                "model_bf16_pad": "model_bf16_pad384", "model_pallas_bf16": "model_pallas_bf16",
                "model_pallas": "model_pallas_f32",
                "model_subpixel": "model_subpixel[pallas, last 2]"}
NOT_PORTED = {"model[ko:all,no_sn,no_bn]", "fused_dec dec3 fused-k64"}


def _finite(res, allow_none=()):
    """Every number in a probe's result (nested dicts) is finite; None only
    under the keys in allow_none."""
    for key, val in res.items():
        if isinstance(val, dict):
            _finite(val, allow_none)
        elif val is None:
            assert key in allow_none, key
        else:
            assert math.isfinite(val), (key, val)


def _run(name, capsys, **kw):
    """Run probe `name` on the CPU; returns (result, printed labels)."""
    res = perf_probe.PROBES[name](CPU, **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    assert not any("FAILED" in ln for ln in lines), lines
    return res, [ln.split(": ")[0] for ln in lines]


@pytest.fixture(autouse=True)
def few_iters(monkeypatch):
    monkeypatch.setattr(perf_probe, "N_ITERS", 2)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_compact_algo_prints_both_algos(capsys):
    """compact_algo, then the stage-2 probes that time the sampler, its
    compactions and the stream flatten: each prints the JAX probe's labels
    and returns finite times."""
    res = perf_probe.probe_compact_algo(CPU, r=4, n=2048 * 3, chunks=(2048,))
    lines = _lines(capsys)
    assert set(res) == {("window", 2048), ("place", 2048)}
    for algo, line in zip(("window", "place"), lines):
        assert re.fullmatch(rf"compact\[{algo}\] chunk=2048 \+payload: [0-9.]+ ms "
                            r"\([0-9.]+ Gelem/s\)", line), line

    for name, labels in STAGE2_LABELS.items():
        res, heads = _run(name, capsys, **STAGE2_KW.get(name, dict(shape=VOX)))
        assert heads == labels, (name, heads)
        _finite(res)

    # the generation chains of `sampler_phases` and `gen` against the same
    # steps on the JAX package's relocate_counts / slope_params
    import jax
    import jax.numpy as jnp
    from jax import lax

    from v2ce_toolbox_tpu.ops.ldati import relocate_counts, slope_params

    v = probes_stage2.voxels(CPU, VOX, seed=3)
    f, p, c, h, w = VOX
    cb, seg, bits = c - 1, p * h * w, 10
    assert bits == int(np.ceil(np.log2(seg)))

    @jax.jit
    def jax_chains(vv):
        counts, tend = relocate_counts(jnp.swapaxes(jnp.flip(vv, 1), 1, 2).reshape(
            f, c, p * h, w))
        k, _ = slope_params(counts.astype(jnp.float32), 30)
        rel = (tend * 3703).astype(jnp.int32).reshape(f, cb, seg)
        iota = lax.broadcasted_iota(jnp.int32, (f, cb, seg), 2)
        phase = jnp.where(jnp.minimum(counts, 32).reshape(f, cb, seg) > 0,
                          (rel << bits) | iota, jnp.int32(2 ** 31 - 1))
        chain = counts == 1
        emit = jnp.maximum(jnp.where(chain, 1, jnp.minimum(counts, 16)), 0)
        ts = ((tend / 30.0 / float(cb)) * 1e6).astype(jnp.int32)
        rel = jnp.where(chain, jnp.clip(ts, 0, 1 << 12), 0)
        keys = jnp.where(emit > 0, (rel << bits) | iota.reshape(counts.shape),
                         jnp.int32(2 ** 31 - 1))
        extra = jnp.minimum(jnp.minimum(jnp.maximum(counts - 1, 0), 15), 255)
        kx = (lax.bitcast_convert_type(k, jnp.int32) & ~jnp.int32(0xFF)) | extra
        return phase, k, keys, kx, emit

    j_phase, j_k, j_keys, j_kx, j_emit = (np.asarray(a) for a in jax_chains(jnp.asarray(
        v.numpy())))
    keys, k = probes_stage2.phase_gen(v)
    np.testing.assert_array_equal(keys.numpy(), j_phase)
    np.testing.assert_array_equal(k.numpy(), j_k)
    for got, want in zip(probes_stage2.gen_chain(v), (j_keys, j_kx, j_emit)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (j_phase != 2 ** 31 - 1).any() and (j_keys != 2 ** 31 - 1).any()

    # `fused_phases`' steps are `driver._flatten_rows` taken apart: the
    # merge step's words and the side list equal its own, byte for byte
    from v2ce_toolbox_tpu_torch.config import SamplerConfig
    from v2ce_toolbox_tpu_torch.ops.ldati import make_draw, sample_rows
    from v2ce_toolbox_tpu_torch.pipeline import driver

    scfg, draw = SamplerConfig(), make_draw(0, 0, CPU)
    offs = torch.arange(f, dtype=torch.int32) * 33_333
    steps = probes_stage2.fused_phase_steps(v, draw, scfg, offs)
    full = driver._flatten_rows(*sample_rows(v, draw, scfg), offs, h=h, w=w,
                                capacity=scfg.event_capacity, frames=f, fps=scfg.fps)
    words, kept = steps["+ merge (no side)"]()
    assert torch.equal(words, full[0]) and int(kept) == int(full[1]) > 0
    side_cand = steps["+ wire prep"]()[3]
    assert int((side_cand != 2 ** 31 - 1).sum()) == int(full[4]) > 0
    assert all(torch.equal(a, b) for a, b in zip(steps["+ merge + side"](), full))


def test_quad_prints_each_layer_and_dtype(capsys):
    """quad, then the stage-1 conv probes (conv_iso, pallas_conv, roofline,
    fused_dec): one line per layer and dtype, finite times; K9's twin
    equals the f32 conv it is held to; fused_dec's `fused-k64` is not
    applicable."""
    res = perf_probe.probe_quad(CPU, layers=[("tiny", 9, 13, 16, 8)], frames=3)
    lines = _lines(capsys)
    assert set(res) == {("tiny", "bf16"), ("tiny", "f32")}
    assert [ln.split(":")[0] for ln in lines] == ["quad tiny bf16", "quad tiny f32"]
    assert all(re.search(r": [0-9.]+ ms  [0-9.]+ TF/s$", ln) for ln in lines), lines

    layer = [("tiny", (1, 2, 6, 7, 16), 8)]
    res, heads = _run("conv_iso", capsys, shapes=layer)
    assert heads == [f"tiny {lab}" for lab in ("conv_f32", "conv_bf16", "mm_f32", "mm_bf16")]
    _finite(res)
    res, heads = _run("pallas_conv", capsys, shapes=layer)
    assert heads == ["tiny f32", "tiny bf16"]
    _finite(res)
    assert all(r["rel_err"] <= 1e-6 for r in res.values()), res
    res, heads = _run("roofline", capsys, mm=64, copy_shape=(4, 64, 64), frames=2,
                      layers=[("head", 16, 24, 2, 8, 1), ("enc1_c1s2", 16, 24, 8, 16, 2)])
    assert heads == ["matmul_bf16 64^3", "matmul_f32 64^3", "hbm_rw 0GiB",
                     "head 16x24 2->8s1 f32", "head 16x24 2->8s1 bf16",
                     "enc1_c1s2 16x24 8->16s2 f32", "enc1_c1s2 16x24 8->16s2 bf16",
                     "sum of layers"]
    _finite(res)
    res, heads = _run("fused_dec", capsys, frames=2,
                      geoms=[("dec3", 4, 5, 8, 9, 8, 4, 4, True),
                             ("dec2", 4, 5, 8, 10, 64, 16, 8, False)])
    assert heads == [f"fused_dec dec3 {v}" for v in ("direct", "up+concat", "fused",
                                                      "fused-k64")] \
        + [f"fused_dec dec2 {v}" for v in ("direct", "up+concat", "fused")]
    _finite(res, allow_none={("dec3", "fused-k64")})


def test_wino_pallas_checks_then_times(capsys):
    res = perf_probe.probe_wino_pallas(CPU, shapes=[("tiny", (1, 8, 9, 13, 16), 8)],
                                       blocks=((8, 8), (4, 4)))
    lines = _lines(capsys)
    assert lines[0].startswith("tiny wino-vs-direct bf16 rel err: ")
    # bf16 Winograd F(4,3) against the direct conv of the same values
    assert res[("tiny", "rel_err_bf16")] < 0.2
    heads = [ln.split(":")[0] for ln in lines[1:]]
    assert heads == ["tiny direct_bf16", "tiny wino4_bf16[lt=8,th=8]",
                     "tiny wino4_bf16[lt=4,th=4]", "tiny direct_f32",
                     "tiny wino4_f32[lt=8,th=8]", "tiny wino4_f32[lt=4,th=4]"]
    assert not any("FAILED" in ln for ln in lines)

    # bf16_fidelity: its two lines and finite numbers; its metrics against
    # the JAX train/metrics, and its KS against the JAX probe's formula, on
    # the same arrays
    import jax.numpy as jnp

    from v2ce_toolbox_tpu.train import metrics as jtm

    res, heads = _run("bf16_fidelity", capsys, seq_len=2, h=16, w=24,
                      model_kw=SMALL["model_kw"])
    assert len(heads) == 2 and heads[0].startswith("bf16_fidelity voxel MAE ") \
        and heads[1].startswith("bf16_fidelity events f32 "), heads
    _finite(res)
    rng = np.random.RandomState(1)
    g = (rng.rand(1, 2, 8, 12, 20) < 0.3) * rng.rand(1, 2, 8, 12, 20).astype(np.float32)
    p = (g + (rng.rand(*g.shape) - 0.5).astype(np.float32) * 0.02).astype(np.float32)
    got = probes_stage2.fidelity_metrics(torch.from_numpy(p), torch.from_numpy(g))
    jp, jg = jnp.asarray(p), jnp.asarray(g)
    want = {"mae": float(jnp.abs(jp - jg).mean()), "f32_mean": float(jnp.abs(jg).mean()),
            "binary_match_raw": float(jtm.binary_match(jp, jg, "raw")),
            "f1_sum_c": float(jtm.binary_match_f1(jp, jg, "sum_c")),
            "pool_mse_k2": float(jtm.pool_mse(jp, jg, 2))}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-12), key
    t_a, t_b = rng.randint(0, 33_333, 500), rng.randint(0, 33_333, 480)
    both = np.sort(np.concatenate([t_a, t_b]))
    ks = float(np.abs(np.searchsorted(np.sort(t_a), both, side="right") / len(t_a)
                      - np.searchsorted(np.sort(t_b), both, side="right") / len(t_b)).max())
    st = probes_stage2.stream_stats(t_a, t_b)
    assert (st["n_f32"], st["n_bf16"], st["count_ratio"], st["ks"]) == (500, 480, 0.96, ks)


def test_wino_ablate_fails_only_noinv(capsys):
    """wino_ablate prints FAILED for 'noinv' alone; the stage-1 model
    probes print no FAILED: model_overhead's knock-out variant prints as
    not ported, every other line a finite time."""
    res = perf_probe.probe_wino_ablate(CPU, shape=(1, 4, 9, 13, 16), cout=8)
    lines = _lines(capsys)
    failed = [ln for ln in lines if "FAILED" in ln]
    assert [ln.split(":")[0] for ln in failed] == ["wino4 bf16 [noinv]", "wino4 f32 [noinv]"]
    assert res[("f32", "nodot")] is not None and res[("f32", "noinv")] is None

    for name, label in MODEL_LABELS.items():
        kw = dict(SMALL, pad_to=(20, 32)) if name.endswith("_pad") else SMALL
        res, heads = _run(name, capsys, **kw)
        assert heads == [label], heads
        _finite(res)
    res, heads = _run("pallas_model", capsys, **SMALL)
    assert heads == [f"pallas_model {v}" for v in ("base", "pallas-last1", "pallas-last2")]
    _finite(res)
    res, heads = _run("batch_scaling", capsys, **SMALL)
    assert heads == [f"model B={b} {d}" for d in ("f32", "bf16") for b in (1, 2, 4)]
    _finite(res)
    res = perf_probe.PROBES["model_overhead"](CPU, **SMALL)
    lines = _lines(capsys)
    assert [ln.split(": ")[0] for ln in lines] == [
        "model[bf16]", "model[no_sn]", "model[no_bn]", "model[no_sn_no_bn]",
        "model[ko:all,no_sn,no_bn]"]
    assert lines[-1].startswith("model[ko:all,no_sn,no_bn]: not ported (conv_impl='ko:all'")
    assert not any("FAILED" in ln for ln in lines)
    _finite(res, allow_none=NOT_PORTED)


def test_cli_rejects_an_unknown_probe():
    """An unknown name is refused; the registry holds the 32 portable
    probes under their JAX names; with `--device cuda` (the default) and no
    card every probe is refused before it runs."""
    with pytest.raises(SystemExit):
        perf_probe.main(["--device", "cpu", "no_such_probe"])
    assert list(perf_probe.PROBES) == list(perf_probe.KERNEL_PROBES) + [
        "sampler", "sort", "sampler_phases", "gen", "flatten", "sampler_strategies",
        "gen_compact", "fused_pipeline", "fused_phases", "bf16_fidelity", "roofline",
        "model", "model_pad", "model_bf16", "model_bf16_pad", "conv_iso", "pallas_conv",
        "model_pallas_bf16", "model_pallas", "model_subpixel", "pallas_model", "fused_dec",
        "batch_scaling", "model_overhead"]
    assert len(perf_probe.PROBES) == 32
    assert set(probes_stage2.KERNELS) | set(probes_stage1.KERNELS) \
        == set(perf_probe.PROBES) - set(perf_probe.KERNEL_PROBES)
    if not torch.cuda.is_available():
        for name in perf_probe.PROBES:
            with pytest.raises(SystemExit, match="torch.cuda.is_available"):
                perf_probe.main([name])
