"""`train.main --device cpu` on 32x40 dummy packets: two steps, the eval
with previews and the recorder, the checkpoints and a resume; the
learning check; the overfit demo's artifact."""

import json
import os
import pickle

import numpy as np
import pytest

from tests.torch_research import two_torch_threads  # noqa: F401
from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
from v2ce_toolbox_tpu_torch.train import main as train_main

pytestmark = pytest.mark.usefixtures("two_torch_threads")

SMALL = ["--batch_size", "2", "--seq_len", "2", "--num_workers", "1",
         "--base_num_channels", "8", "--num_encoders", "2", "--device", "cpu"]


def _lines(work_dir, kind):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [x[kind] for x in map(json.loads, f) if kind in x]


def test_train_main_runs_evals_and_resumes(tmp_path):
    """Two steps of the default loss stack, the eval with previews and a
    recorder dump, the checkpoints; then a resumed run starts from the
    saved step. 20 packets: 16 train, 2 val, 2 test."""
    packets = str(tmp_path / "packets")
    generate(packets, num_packets=20, height=32, width=40, events_per_frame=64)
    log_dir = str(tmp_path / "logs")
    first = train_main.main(SMALL + [
        "--data_dir", packets, "--log_dir", log_dir, "--exp_name", "first",
        "--max_epochs", "1", "--max_steps_per_epoch", "2", "--log_frequency", "1",
        "--gan_k", "2", "--record_predictions", "1"])
    work = first["work_dir"]
    train = _lines(work, "train")
    assert [x["global_step"] for x in train] == [1, 2]
    for x in train:
        assert {"loss", "d_loss", "pyramid_loss", "gan_loss", "ef_loss", "compensation"} <= set(x)
        assert all(np.isfinite(v) for v in x.values())
    ev = _lines(work, "eval")
    assert len(ev) == 1 and "BinaryMatchF1_sum_c" in ev[0] and "val_loss" in ev[0]
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["best-epoch=0", "last"]
    assert os.path.getsize(os.path.join(work, "previews", "epoch0.png")) > 0
    rec = pickle.load(open(os.path.join(work, "recorder", "val-e0-b0.pkl"), "rb"))
    assert rec["pred_voxels"].shape == rec["gt_voxels"].shape == (2, 2, 32, 40, 20)
    assert len(first["step_s"]) == 2

    resumed = train_main.main(SMALL + [
        "--data_dir", packets, "--log_dir", log_dir, "--exp_name", "resumed",
        "--max_epochs", "1", "--max_steps_per_epoch", "1", "--log_frequency", "1",
        "--gan_k", "1", "--dump_previews", "false",
        "--load_dir", os.path.join(work, "checkpoints")])
    assert _lines(resumed["work_dir"], "train")[0]["global_step"] == 3
    assert resumed["state"].step == 3


def test_train_loss_descends(tmp_path):
    """The analogue of `test_train_loss_descends_50_steps`: the full
    default loss stack on 32x40 dummy packets at base 8, 20 steps, the
    mean of the last fifth under 0.9 times the mean of the first."""
    data = str(tmp_path / "data")
    generate(data, num_packets=64, height=32, width=40, events_per_frame=64)
    out = train_main.main(SMALL + [
        "--data_dir", data, "--log_dir", str(tmp_path / "logs"), "--exp_name", "descend",
        "--max_epochs", "1", "--max_steps_per_epoch", "20", "--log_frequency", "1",
        "--gan_k", "1", "--dump_previews", "false"])
    losses = [x["loss"] for x in _lines(out["work_dir"], "train")]
    assert len(losses) == 20 and np.isfinite(losses).all()
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < 0.9 * first, (first, last)


def _jax_overfit_keys():
    """The keys of the dict that `tools/overfit_demo.py`'s write_artifact
    dumps."""
    import ast

    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools", "overfit_demo.py")
    fn = next(n for n in ast.walk(ast.parse(open(src).read()))
              if isinstance(n, ast.FunctionDef) and n.name == "write_artifact")
    d = next(n for n in ast.walk(fn) if isinstance(n, ast.Dict))
    return {k.value for k in d.keys}


def test_overfit_demo_writes_the_jax_artifact_schema(tmp_path):
    from v2ce_toolbox_tpu_torch.tools import overfit_demo

    out = str(tmp_path / "overfit.json")
    with pytest.raises(SystemExit) as e:
        overfit_demo.main(["--steps", "1", "--target", "0", "--batch_size", "2",
                           "--device", "cpu", "--out", out])
    assert e.value.code == 0
    art = json.load(open(out))
    assert set(art) == _jax_overfit_keys()
    assert art["reached_at_step"] == 1 and art["devices"] == 1


def test_overfit_demo_over_two_ranks(tmp_path):
    """`--devices 2`: two gloo ranks, 1 item each; rank 0 writes the
    artifact."""
    from v2ce_toolbox_tpu_torch.tools import overfit_demo

    out = str(tmp_path / "overfit.json")
    with pytest.raises(SystemExit) as e:
        overfit_demo.main(["--steps", "1", "--target", "0", "--batch_size", "2",
                           "--device", "cpu", "--devices", "2", "--out", out])
    assert e.value.code == 0
    art = json.load(open(out))
    assert set(art) == _jax_overfit_keys()
    assert art["reached_at_step"] == 1 and art["devices"] == 2
