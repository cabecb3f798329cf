"""The port's stage tools against the JAX package and the root tools:
`tools/speed_test` (parameters and conv FLOPs of V2ce3d), `tools/perf_test_stage2`
(LDATI's events on the JAX tool's voxels) and `tools/vis_stage2` (the
samplers side by side, with and without matplotlib)."""

import math
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.ops import ldati as jl
from v2ce_toolbox_tpu_torch.config import ModelConfig, SamplerConfig
from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.ops import ldati, samplers
from v2ce_toolbox_tpu_torch.tools import perf_test_stage2, speed_test, vis_stage2
from v2ce_toolbox_tpu_torch.utils.weights import init_weights
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(base_num_channels=4, num_encoders=2, num_residual_blocks=1)


def jax_counts(cfg, shape):
    """(params, conv FLOPs) of the JAX V2ce3d from its program alone: the
    `params` leaves of `eval_shape(init)`, and 2 x prod(out) x prod(kernel
    spatial) x Cin/groups over every `conv_general_dilated` of the traced
    eval apply, nested jaxprs included."""
    model = JaxV2ce3d(config=JaxModelConfig(**cfg))
    variables = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros(shape),
                                                  train=False))
    params = sum(math.prod(v.shape) for v in jax.tree.leaves(variables["params"]))
    closed = jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(
        variables, jax.ShapeDtypeStruct(shape, jnp.float32))

    def walk(jaxpr):
        flops = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "conv_general_dilated":
                rhs_spec = eqn.params["dimension_numbers"].rhs_spec
                rhs = eqn.invars[1].aval.shape            # (O, I/groups, *spatial) by rhs_spec
                flops += (2 * math.prod(eqn.outvars[0].aval.shape) * rhs[rhs_spec[1]]
                          * math.prod(rhs[d] for d in rhs_spec[2:]))
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else [p]:
                    if hasattr(sub, "eqns"):
                        flops += walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        flops += walk(sub.jaxpr)
        return flops

    return params, walk(closed.jaxpr)


def test_speed_test_counts_match_jax(capsys):
    shape = (1, 3, 20, 26, 2)
    want = jax_counts(SMALL, shape)
    assert want[1] > 0
    assert speed_test.counts(ModelConfig(**SMALL), shape) == want
    model = V2ce3d(ModelConfig(**SMALL))
    init_weights(model, 0)
    y, flops = speed_test.forward_flops(model.eval(), torch.zeros(shape))
    assert flops == want[1] and y.shape == (1, 3, 20, 26, 20)
    # the tool at full width, tiny frames, on the CPU: its counts and lines
    out = speed_test.main(["--device", "cpu", "--height", "16", "--width", "16",
                           "--seq_len", "2", "--iters", "1"])
    full = jax_counts({}, (1, 2, 16, 16, 2))
    assert (out["params"], out["flops"]) == full
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"params: {full[0] / 1e6:.2f} M"
    assert lines[1] == f"analytical flops/forward: {full[1] / 1e9:.1f} G"
    assert re.fullmatch(r"avg forward latency: \d+\.\d\d ms \(\d+\.\d frames/s, "
                        r"\d+\.\d\d TFLOP/s effective\)", lines[2])


def test_perf_test_stage2_none_matches_jax(capsys):
    args = ["--batch", "2", "--height", "16", "--width", "20", "--iters", "2",
            "--strategy", "none", "--device", "cpu"]
    # the JAX tool's voxels (tools/perf_test_stage2.py:42-45)
    rng = np.random.RandomState(42)
    shape = (2, 2, 10, 16, 20)
    y = (rng.rand(*shape) * 2 * (rng.rand(*shape) < 0.1)).astype(np.float32)
    assert np.array_equal(perf_test_stage2.voxels(2, 16, 20, 0.1), y)

    # 'none' draws nothing on the v3 core: a provider that raises is never
    # called (the v2 core draws slot 0 and discards it)
    def no_draw(j, shape):
        raise AssertionError(f"'none' drew {j} {shape}")

    cfg = SamplerConfig(additional_events_strategy="none")
    direct = ldati.sample_events(torch.from_numpy(y), no_draw, cfg)
    # the JAX tool's first call (its later ones shift the voxels), through
    # the JAX v2 core: with no cap binding every route emits exactly the
    # count-1 voxels under 'none', and this one runs no Pallas kernel in
    # interpret mode (1.5 s against the v3 core's 10.5 s here)
    want = int(jl.sample_events(jnp.asarray(y), jax.random.fold_in(jax.random.key(0), 0),
                                additional_events_strategy="none", use_v3=False).count.sum())
    assert int(ldati.sample_events(torch.from_numpy(y), ldati.make_draw(0, 0, "cpu"), cfg,
                                   use_v3=False).count.sum()) == want
    assert want > 0 and int(direct.count.sum()) == want
    out = perf_test_stage2.main(args)
    assert out["events_per_call"] == want and out["events_per_frame"] == want / 2
    line = capsys.readouterr().out.strip()
    assert line == perf_test_stage2.report_line(out["ms_per_frame"], out["frames_per_s"],
                                                out["events_per_s"], out["events_per_frame"])
    # the JAX tool's format (tools/perf_test_stage2.py:60-63)
    assert re.fullmatch(r"\d+\.\d{3} ms/frame  \(\d+\.\d frames/s, \d+\.\d\d M events/s, "
                        rf"{round(want / 2)} events/frame\)", line)


def test_vis_stage2_streams_and_plots(tmp_path, monkeypatch, capsys):
    streams = vis_stage2.sampler_streams("cpu", seed=3)
    gt = streams["gt"]
    assert len(gt) == 4000 and np.all(np.diff(gt["timestamp"]) >= 0)
    v = gen_discretized_event_volume_np(gt, (20, 64, 80)).reshape(1, 2, 10, 64, 80)
    direct = {
        "ldati": ldati.sample_voxel_statistical(v, draw=ldati.make_draw(3, 0, "cpu"),
                                                device="cpu")[0],
        "random": samplers.sample_voxel_baseline(v, random=True,
                                                 draw=ldati.make_draw(3, 0, "cpu"),
                                                 device="cpu")[0],
        "even": samplers.sample_voxel_baseline(v, even=True, draw=ldati.make_draw(3, 0, "cpu"),
                                               device="cpu")[0],
        "slope": samplers.sample_voxel_pure_slope(v, draw=ldati.make_draw(3, 0, "cpu"),
                                                  device="cpu")[0]}
    assert list(streams) == ["gt", *direct]
    for name, rec in direct.items():
        assert len(rec) > 0 and streams[name].tobytes() == rec.tobytes(), name

    counts = vis_stage2.main(["-o", str(tmp_path / "plots"), "--device", "cpu", "--seed", "3"])
    assert counts == {name: len(s) for name, s in streams.items()}
    printed = capsys.readouterr().out.splitlines()
    assert printed[:5] == [f"{name}: {n} events" for name, n in counts.items()]
    assert sorted(p.name for p in (tmp_path / "plots").iterdir()) == sorted(
        ["timestamp_hist.png"] + [f"xyt_{name}.png" for name in counts])

    # without matplotlib: the counts, then a non-zero exit that names it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib") as e:
        vis_stage2.main(["-o", str(tmp_path / "none"), "--device", "cpu", "--seed", "3"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out.splitlines() == printed[:5]
    assert not (tmp_path / "none").exists()
