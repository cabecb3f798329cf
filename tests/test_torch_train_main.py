"""The port's training utilities on the CPU: checkpoints and their
resolution (against the JAX `best_or_last`), `train.main`'s refusals,
the baseline scorer against the JAX one, and the runtime utilities.
`train.main`'s runs are in `test_torch_train_run.py`."""

import os

import numpy as np
import pytest
import torch

from tests.torch_research import two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu.eval import baseline_metrics as jbaseline
from v2ce_toolbox_tpu.utils.checkpoint import best_or_last as jax_best_or_last
from v2ce_toolbox_tpu_torch.config import ModelConfig, TrainConfig
from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
from v2ce_toolbox_tpu_torch.eval import baseline_metrics
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.train import gan, main as train_main, state as tstate
from v2ce_toolbox_tpu_torch.train import step as tstep
from v2ce_toolbox_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.usefixtures("two_torch_threads")

SMALL = ["--batch_size", "2", "--seq_len", "2", "--num_workers", "1",
         "--base_num_channels", "8", "--num_encoders", "2", "--device", "cpu"]


def _state(seed):
    model = V2ce3d(ModelConfig(base_num_channels=4, num_encoders=2))
    cfg = TrainConfig(loss="pyramid+gan+ef", lr_scheduler=None)
    return tstate.create_train_state(model, cfg, disc=gan.PatchDiscriminator2D(), seed=seed), cfg


def test_checkpoint_round_trip(tmp_path):
    """One trained step saved and loaded into a fresh state: every tensor
    of the model (BN statistics and SN vectors too), the discriminator,
    both optimizers' moments, and the step."""
    ts, cfg = _state(0)
    rng = np.random.RandomState(0)
    batch = {"image_units": torch.from_numpy(rng.randn(1, 2, 24, 24, 2).astype(np.float32)),
             "voxels": torch.from_numpy(rng.rand(1, 2, 24, 24, 20).astype(np.float32))}
    ts, _ = tstep.make_train_step(ts.model, cfg, disc=ts.disc, gan_k=1)(ts, batch)
    path = str(tmp_path / "ckpts" / "last")
    checkpoint.save_checkpoint(path, ts)
    assert os.listdir(tmp_path / "ckpts") == ["last"]
    fresh, _ = _state(1)
    checkpoint.load_checkpoint(path, target=fresh)
    assert fresh.step == ts.step == 1
    for a, b in ((ts.model, fresh.model), (ts.disc, fresh.disc)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
    for a, b in ((ts.opt, fresh.opt), (ts.disc_opt, fresh.disc_opt)):
        for sa, sb in zip(a.state_dict()["state"].values(), b.state_dict()["state"].values()):
            assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("entries", [["best-epoch=1", "best-epoch=10", "best-epoch=9", "last"],
                                     ["last"], ["best-x"], ["other"], []])
def test_best_or_last_matches_jax(tmp_path, entries):
    for e in entries:
        (tmp_path / e).write_bytes(b"")
    for prefer in (True, False):
        assert (checkpoint.best_or_last(str(tmp_path), prefer)
                == jax_best_or_last(str(tmp_path), prefer))
    assert checkpoint.best_or_last(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("flags,error,match", [
    (["--device", "cuda", "--devices", "2"], ValueError, "more than the 1 visible GPU"),
    (["--num_processes", "2"], ValueError, "needs --coordinator"),
    (["--num_processes", "2", "--process_id", "2", "--coordinator", "localhost:1234"],
     ValueError, "not in \\[0, --num_processes 2\\)"),
    (["--model_name", "v2ce_2d"], NotImplementedError, "only")])
def test_train_main_refuses_unported_flags(tmp_path, monkeypatch, flags, error, match):
    """Refused before anything is read or written (a host with one GPU
    stands in for the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(error, match=match):
        train_main.main(SMALL + ["--data_dir", str(tmp_path / "absent"),
                                 "--log_dir", str(tmp_path)] + flags)
    assert not os.listdir(tmp_path)


def test_train_main_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a host without a card")
    args = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        train_main.main(args + ["--data_dir", str(tmp_path / "absent"),
                                "--log_dir", str(tmp_path)])


def _stream(rng, n, h, w, t_end):
    ev = np.zeros(n, EVENT_DTYPE)
    ev["timestamp"] = np.sort(rng.randint(0, t_end, n))
    ev["x"], ev["y"] = rng.randint(0, w, n), rng.randint(0, h, n)
    ev["polarity"] = rng.randint(0, 2, n)
    return ev


def test_baseline_metrics_match_jax(tmp_path):
    """One synthetic simulator stream scored against GT voxels, with and
    without frame timestamps; then the CLI over two packets."""
    rng = np.random.RandomState(3)
    h, w = 24, 30
    pred = _stream(rng, 4000, h, w, 16000)
    gt = baseline_metrics.voxelize_stream(_stream(rng, 3000, h, w, 16000), 16, 10, (h, w))
    ts = np.sort(rng.randint(0, 16000, 17)).astype(np.int64)
    for stamps in (None, ts):
        got = baseline_metrics.score_stream_against_gt(pred, gt, timestamps=stamps)
        want = jbaseline.score_stream_against_gt(pred, gt, timestamps=stamps)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)

    from v2ce_toolbox_tpu_torch.tools import baseline_metric

    data = str(tmp_path / "packets")
    generate(data, num_packets=2, height=h, width=w, events_per_frame=50)
    npz = str(tmp_path / "events.npz")
    np.savez(npz, event_stream=_stream(rng, 5000, h, w, 1000000))
    scores = baseline_metric.main(["--pred", npz, "--data_dir", data])
    assert set(scores) == set(want) and all(np.isfinite(v) for v in scores.values())


def test_runtime_utilities(tmp_path, caplog):
    """The working tree, Timer and tic_toc, device_trace's Chrome trace,
    and the debug checks' FloatingPointError on a non-finite log term."""
    import logging

    from v2ce_toolbox_tpu_torch.utils import runtime

    tree = runtime.build_working_tree(str(tmp_path), "exp")
    assert all(os.path.isdir(p) for p in tree.values())
    with caplog.at_level(logging.INFO):
        with runtime.Timer("block") as t:
            pass
        assert runtime.tic_toc(lambda: 3)() == 3
    assert t.elapsed >= 0 and "block took" in caplog.text
    with runtime.device_trace(tree["profile"]) as prof:
        torch.ones(8).sum()
    assert prof.key_averages() and os.path.getsize(os.path.join(tree["profile"], "trace.json"))
    runtime.enable_debug_checks(True)
    try:
        assert runtime.debug_checks_enabled()
        with pytest.raises(FloatingPointError, match="loss"):
            runtime.check_finite({"loss": torch.tensor(float("nan")), "d_loss": 1.0})
    finally:
        runtime.enable_debug_checks(False)
    assert not runtime.debug_checks_enabled()
