"""The port's stage-2 metrics (`v2ce_toolbox_tpu_torch/eval/stage2_metrics.py`)
against the JAX package's on the same arrays, `evaluate_samplers_on_frame`
over all seven samplers with each sampler fed the JAX draws of its key,
and the port's `tools/stage2_eval` on two small pickled packets."""

import os
import pickle

import numpy as np
import pytest
import jax

from v2ce_toolbox_tpu.eval import stage2_metrics as jm
from v2ce_toolbox_tpu_torch.eval import stage2_metrics as tm
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.ops import ldati

from tests.test_torch_samplers import sampler_draw
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)


def _events(n, h, w, t_max=100000, seed=0):
    rng = np.random.RandomState(seed)
    ev = np.zeros((n,), dtype=EVENT_DTYPE)
    ev["timestamp"] = np.sort(rng.randint(0, t_max, (n,)))
    ev["x"] = rng.randint(0, w, (n,))
    ev["y"] = rng.randint(0, h, (n,))
    ev["polarity"] = rng.randint(0, 2, (n,))
    return ev


@pytest.mark.parametrize("search_range", [0, 1])
def test_ts_diff_metric_matches_jax(search_range):
    gt = _events(500, 20, 24, t_max=20000, seed=1)
    gt["polarity"][::7] = -1                        # the GT's -1 for OFF
    pred = _events(700, 20, 24, t_max=20000, seed=2)
    for a, b in [(gt, pred), (gt, pred[:0]), (gt[:0], pred)]:
        got = tm.ts_diff_metric(a, b, search_range=search_range, fps=30, width=24, height=20)
        ref = jm.ts_diff_metric(a, b, search_range=search_range, fps=30, width=24, height=20)
        assert np.array_equal(got, ref)
    assert tm.event_count_ratio(gt, pred) == jm.event_count_ratio(gt, pred) == 1.4
    assert tm._pixel_id(3, 4, 1, 20) == jm._pixel_id(3, 4, 1, 20)


def test_roundtrip_voxel_consistency_matches_jax():
    rng = np.random.RandomState(0)
    voxel = (rng.rand(2, 10, 12, 14) * 3 * (rng.rand(2, 10, 12, 14) < 0.4)).astype(np.float32)
    rec = ldati.sample_voxel_statistical(voxel[None], capacity=1 << 13, device="cpu")[0]
    got = tm.roundtrip_voxel_consistency(voxel, rec)
    assert got == jm.roundtrip_voxel_consistency(voxel, rec)
    assert got["pred_total"] == got["relocated_total"] > 0 and got["abs_diff_mean"] < 0.01


def test_evaluate_samplers_on_frame_matches_jax():
    # at 1 fps a 2x64x130 frame's voxel ids leave the packed key too few
    # bits, so LDATI runs the v2 core in both packages (the v3 core's
    # Pallas kernels would run interpreted for ~60 s); every sampler then
    # draws per frame, as `sampler_draw` gives them
    rng = np.random.RandomState(4)
    h, w = 64, 130
    gt = _events(600, h, w, t_max=1_000_000, seed=5)
    voxel = (rng.rand(2, 10, h, w) * 2 * (rng.rand(2, 10, h, w) < 0.3)).astype(np.float32)
    key = jax.random.key(1)
    assert not ldati.supports_rows(2, h, w, fps=1)
    got = tm.evaluate_samplers_on_frame(gt, voxel, samplers=tm.SAMPLERS, fps=1,
                                        draws=lambda name: sampler_draw(key, 1), device="cpu")
    ref = jm.evaluate_samplers_on_frame(gt, voxel, samplers=tm.SAMPLERS, fps=1, key=key)
    assert got == ref
    for d, o, r in got.values():
        assert 0 < d <= 3e5 and o >= 0 and r > 0
    with pytest.raises(ValueError):
        tm.evaluate_samplers_on_frame(gt, voxel, samplers=["bogus"], device="cpu")


def test_stage2_eval_main(tmp_path):
    from v2ce_toolbox_tpu_torch.data.dummy_data_gen import make_packet
    from v2ce_toolbox_tpu_torch.tools import stage2_eval

    rng = np.random.RandomState(0)
    data = tmp_path / "packets"
    data.mkdir()
    for i in range(2):
        with open(data / f"{i:05d}.pkl", "wb") as f:
            pickle.dump(make_packet(rng, 16, 20, num_frames=4, events_per_frame=300), f)
    out = tmp_path / "table.csv"
    table = stage2_eval.main(["--data_dir", str(data), "--max_frames_per_file", "2",
                              "--device", "cpu", "-o", str(out)])
    assert open(out).read() == table + "\n"
    rows = [r.split(",") for r in table.splitlines()]
    assert rows[0] == ["sampler", "avg_error_us", "overflow", "pred_gt_ratio"]
    assert [r[0] for r in rows[1:]] == ["ldati", "random", "even", "slope"]
    for _, d, o, r in rows[1:]:
        assert 0 < float(d) <= 1e4 and float(o) >= 0 and float(r) > 0
    assert os.path.getsize(out) > 0
