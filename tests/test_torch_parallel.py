"""Data-parallel training of the port (`parallel/mesh.py`) on gloo ranks,
spawned CPU processes that import no JAX (`tests/torch_parallel_ranks.py`),
against the JAX package's mesh step and against one rank.

  * one eval step and one train step (GAN on, the default loss stack with
    norml1 and norml2) on 2 ranks, 2 items each, against JAX's
    `make_eval_step` / `make_train_step(..., mesh=make_mesh(2))` on the
    same global batch of 4 and the same weights: logs, metrics (F1 too)
    and BN statistics within rtol 1e-4, parameters within rtol 1e-4 but
    the projection biases before a train-mode BN, which move up to 2 lr
    either way from rounding-level gradients (ROADMAP P11), and a share of
    at most 1e-4 of the discriminator's elements, which its Adam (beta1 0)
    moves up to 2 lr an update for the same reason; both Adams' moments
    (which, unlike Adam's step, hold the gradients' scale) within 1e-4 of
    each tensor's largest element, those biases aside; the two ranks hold
    one state, bit for bit; the same world with remat (each block's
    forward, global-batch BN all_reduce included, run again in the
    backward) holds that state bit for bit;
  * BatchNorm3d's train mode on 2 ranks against 1 rank on the whole batch:
    outputs, running statistics, input and weight gradients;
  * `train.main` as two processes joined by `--coordinator`, and under
    torchrun, against `--devices 2`: the same losses and metrics, the
    recorder holding the whole batch, nothing written by rank 1; `launch`
    and `init_distributed`, given no device, refuse where no GPU is seen.

Every world rendezvouses under the test's temporary directory, with a
collective timeout of 60 s and a wall limit of 120 s."""

import json
import os
import socket
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_parallel_ranks as ranks
from tests.test_torch_streaming import one_torch_thread  # noqa: F401
from tests.torch_research import fill_variables
from v2ce_toolbox_tpu.config import ModelConfig as JaxModelConfig
from v2ce_toolbox_tpu.config import TrainConfig as JaxTrainConfig
from v2ce_toolbox_tpu.models import V2ce3d as JaxV2ce3d
from v2ce_toolbox_tpu.parallel.mesh import make_mesh
from v2ce_toolbox_tpu.train import gan as jgan
from v2ce_toolbox_tpu.train import state as jstate
from v2ce_toolbox_tpu.train import step as jstep
from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
from v2ce_toolbox_tpu_torch.parallel import mesh as pmesh
from v2ce_toolbox_tpu_torch.train import main as train_main
from v2ce_toolbox_tpu_torch.utils.weights import discriminator_from_jax_params, from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(base_num_channels=4, num_encoders=2)
NB = dict(num_encoders=2, num_residual_blocks=2)
B, L, H, W = 4, 2, 24, 24
CFG = dict(loss="pyramid+gan+ef+ef_splitp+compensation+norml1+norml2", lr=1e-3,
           weight_decay=1e-5, lr_scheduler="step", lr_decay_steps=1, lr_decay_rate=0.5,
           lr_decay_min_lr=1e-6)
GAN_K, STEPS_PER_EPOCH = 2, 1
DISC_LR = 1e-5                      # train/gan.make_disc_optimizer
RTOL, ATOL = 1e-4, 1e-6
DEAD = "downsample.0.bias"          # ROADMAP P11: may part by 2 lr
WALL_S, COLLECTIVE_S = 120, 60


def _launch(tmp, fn, n, *args):
    """A world of n gloo ranks, rendezvousing under `tmp`."""
    with mock.patch.object(tempfile, "tempdir", str(tmp)):
        return pmesh.launch(fn, n, args=args, devices=["cpu"] * n, timeout_s=WALL_S,
                            collective_timeout_s=COLLECTIVE_S)


def _batch(seed):
    rng = np.random.RandomState(seed)
    units = rng.randn(B, L, H, W, 2).astype(np.float32)
    vox = (rng.rand(B, L, H, W, 20) * 3 * (rng.rand(B, L, H, W, 20) < 0.2)).astype(np.float32)
    return {"image_units": units, "voxels": vox}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's mesh eval and train steps from one state, and the port's on 2
    ranks from that state converted."""
    jmodel = JaxV2ce3d(config=JaxModelConfig(**TINY))
    jdisc = jgan.PatchDiscriminator2D()
    variables = fill_variables(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, L, H, W, 2)), train=False), 0)
    dparams = fill_variables(
        lambda: jdisc.init(jax.random.key(1), jnp.zeros((1, H, W, 20))), 1)["params"]
    jcfg = JaxTrainConfig(**CFG)
    js = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], sn=variables["sn"],
        opt_state=jstate.make_optimizer(jcfg, STEPS_PER_EPOCH).init(variables["params"]),
        disc_params=dparams, disc_opt_state=jgan.make_disc_optimizer().init(dparams))
    mesh = make_mesh(2)
    batch, eval_batch = _batch(20), _batch(21)
    jeval = jstep.make_eval_step(jmodel, jcfg, mesh=mesh)(js, eval_batch)
    jtrain = jstep.make_train_step(jmodel, jcfg, disc=jdisc, gan_k=GAN_K,
                                   steps_per_epoch=STEPS_PER_EPOCH, mesh=mesh, donate=False)
    js1, jlogs = jtrain(js, batch)
    port = [_launch(tmp_path_factory.mktemp("world"), ranks.train_rank, 2,
                    from_jax_variables(variables, **NB), discriminator_from_jax_params(dparams),
                    batch, eval_batch, dict(TINY, remat=remat), CFG, GAN_K, STEPS_PER_EPOCH)
            for remat in (False, True)]
    return (jax.tree_util.tree_map(np.asarray, (js1, jlogs)),
            {k: float(v) for k, v in jeval.items()}, port)


def test_two_ranks_train_to_the_jax_mesh_state(run):
    """The logs and eval metrics; generator parameters, BN statistics and
    SN vectors, the discriminator, and both Adams' moments, after the step;
    one state on both ranks; with remat, the same state and logs."""
    (js1, jlogs), jeval, (port, remat) = run
    for got, want in ((port[0]["logs"], jlogs), (port[0]["metrics"], jeval)):
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("logs", "metrics"):
        assert port[0][k] == port[1][k]
    snap = port[0]["state"]
    assert snap["step"] == int(js1.step) == 1
    for k, v in from_jax_variables(js1.model_variables(), **NB).items():
        if k.endswith("num_batches_tracked"):
            continue
        if DEAD in k:
            assert np.abs(snap["model"][k] - v.numpy()).max() <= 2 * CFG["lr"] * (1 + 1e-3), k
        else:
            np.testing.assert_allclose(snap["model"][k], v.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    # Adam with beta1 0 moves a rounding-level gradient by its full lr: a
    # few elements may part by up to 2 lr an update (P11)
    reach = 2 * GAN_K * DISC_LR
    for k, v in discriminator_from_jax_params(js1.disc_params).items():
        got, want = snap["disc"][k], v.numpy()
        apart = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
        assert apart.mean() <= 1e-4 and np.abs(got - want)[apart].max(initial=0) <= reach, k
    # Adam's step does not move when every gradient is scaled alike, its
    # moments do. A moment is held within RTOL of its tensor's largest
    # element: an element of a rounding-level gradient may part far more
    # than RTOL of itself, as P11's biases do, which are left out.
    for part, tree, convert in (
            ("m1", js1.opt_state[1].mu, None), ("m2", js1.opt_state[1].nu, None),
            ("dm1", js1.disc_opt_state[1].mu, discriminator_from_jax_params),
            ("dm2", js1.disc_opt_state[1].nu, discriminator_from_jax_params)):
        want = (convert(tree) if convert else
                from_jax_variables(dict(js1.model_variables(), params=tree), **NB))
        assert snap[part].keys() <= want.keys()
        for k, got in snap[part].items():
            if DEAD not in k:
                w = want[k].numpy()
                np.testing.assert_allclose(got, w, rtol=0, atol=RTOL * np.abs(w).max(),
                                           err_msg=(part, k))
    a, b = (r["state"] for r in port)
    for c in (b, remat[0]["state"], remat[1]["state"]):
        for part in ("model", "m1", "m2", "disc", "dm1", "dm2"):
            assert a[part].keys() == c[part].keys()
            for k in a[part]:
                assert np.array_equal(a[part][k], c[part][k]), (part, k)
    for k in ("logs", "metrics"):
        assert remat[0][k] == remat[1][k] == port[0][k], k


def test_batchnorm_over_the_global_batch(tmp_path):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 3, 2, 5, 6).astype(np.float32) * 2 + 1)
    w_out = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    weight = torch.from_numpy(rng.rand(3).astype(np.float32) + 0.5)
    bias = torch.from_numpy(rng.randn(3).astype(np.float32))
    one = ranks.bn_rank(None, x, w_out, weight, bias)
    two = _launch(tmp_path, ranks.bn_rank, 2, x, w_out, weight, bias)
    for k in ("out", "x_grad"):
        np.testing.assert_allclose(torch.cat([r[k] for r in two]).numpy(), one[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("weight_grad", "bias_grad"):       # each rank's share of the global sum
        np.testing.assert_allclose(sum(r[k] for r in two).numpy(), one[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("running_mean", "running_var"):
        assert torch.equal(two[0][k], two[1][k])
        np.testing.assert_allclose(two[0][k].numpy(), one[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _lines(work_dir, kind):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [x[kind] for x in map(json.loads, f) if kind in x]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_processes_train_as_spawned_ranks(tmp_path):
    """`--num_processes 2 --process_id {0,1} --coordinator` (two processes
    started here, as `__graft_entry__.dryrun_multihost` does) and
    `torchrun --standalone --nproc_per_node 2` against `--devices 2`: two
    steps and an eval of a global batch of 2. And a world whose devices are
    not named is refused where no GPU is visible."""
    import pickle

    # ranks go to the GPUs unless the CPU is named: without a GPU, refused
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        for start in (lambda: pmesh.launch(ranks.bn_rank, 2),
                      lambda: pmesh.init_distributed(f"127.0.0.1:{_free_port()}", 2, 0)):
            with pytest.raises(RuntimeError, match="no GPU is visible"):
                start()
    data = str(tmp_path / "packets")
    generate(data, num_packets=20, height=32, width=40, events_per_frame=64)
    common = ["--data_dir", data, "--batch_size", "2", "--seq_len", "2", "--num_workers", "1",
              "--base_num_channels", "8", "--num_encoders", "2", "--device", "cpu",
              "--max_epochs", "1", "--max_steps_per_epoch", "2", "--log_frequency", "1",
              "--gan_k", "1", "--dump_previews", "false", "--record_predictions", "1",
              "--exp_name", "dp", "--logging_level", "warning"]
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    module = ["-m", "v2ce_toolbox_tpu_torch.train.main", *common]
    cmds = [[sys.executable, *module, "--log_dir", str(tmp_path / f"host{i}"), "--coordinator",
             coord, "--num_processes", "2", "--process_id", str(i)] for i in range(2)]
    cmds.append([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", *module, "--log_dir", str(tmp_path / "torchrun")])
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    try:                    # the spawned world trains while the others do
        with mock.patch.object(tempfile, "tempdir", str(tmp_path)):
            spawned = train_main.main(common + ["--log_dir", str(tmp_path / "spawned"),
                                                "--devices", "2"])
        outs = [p.communicate(timeout=WALL_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert len(spawned["ranks"]) == 2
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert not os.path.exists(tmp_path / "host1")          # rank 1 writes nothing
    hosted = str(tmp_path / "host0" / "dp")
    for work in (hosted, str(tmp_path / "torchrun" / "dp")):
        for kind in ("train", "eval"):
            a, b = _lines(spawned["work_dir"], kind), _lines(work, kind)
            assert len(a) == len(b) == (2 if kind == "train" else 1)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                np.testing.assert_allclose([x[k] for k in x], [y[k] for k in x], rtol=1e-6,
                                           atol=1e-9)
    rec = pickle.load(open(os.path.join(hosted, "recorder", "val-e0-b0.pkl"), "rb"))
    assert rec["pred_voxels"].shape == rec["gt_voxels"].shape == (2, 2, 32, 40, 20)
    assert sorted(os.listdir(os.path.join(hosted, "checkpoints"))) == ["best-epoch=0", "last"]
