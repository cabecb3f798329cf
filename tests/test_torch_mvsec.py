"""The port's MVSEC converter (`v2ce_toolbox_tpu_torch/data/mvsec.py`)
against the JAX package's, on the synthetic recording of
`tests/test_utils_and_eval.py::test_mvsec_flow_fields_and_exporters`
stretched to 33 frames (2 packets, so both acc_flow rules run), with the
same FastFlowNet weights on both sides (flax variables drawn with numpy,
converted for the port): every non-flow field identical, `optical_flow`
and `acc_flow` within 1e-4 of the largest |flow|, and the exporters'
files byte-identical."""

import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_research import fill_variables
from v2ce_toolbox_tpu.data import mvsec as jmvsec
from v2ce_toolbox_tpu.models import fastflownet as jffn
from v2ce_toolbox_tpu_torch.data import mvsec
from v2ce_toolbox_tpu_torch.utils.weights import fastflownet_from_jax_variables
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

N_FRAMES, H, W, N_EVENTS = 33, 32, 40, 500
FLOW_TOL = 1e-4


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    import h5py

    rng = np.random.RandomState(1)
    path = str(tmp_path_factory.mktemp("mvsec") / "synth_data.hdf5")
    ts = np.arange(N_FRAMES) / 30.0
    ev = np.zeros((N_EVENTS, 4))
    ev[:, 0] = rng.randint(0, W, N_EVENTS)
    ev[:, 1] = rng.randint(0, H, N_EVENTS)
    ev[:, 2] = np.sort(rng.rand(N_EVENTS)) * ts[-1]
    ev[:, 3] = rng.choice([-1, 1], N_EVENTS)
    with h5py.File(path, "w") as f:
        g = f.create_group("davis/left")
        g.create_dataset("image_raw", data=rng.randint(0, 255, (N_FRAMES, H, W),
                                                       dtype=np.uint8))
        g.create_dataset("image_raw_ts", data=ts)
        g.create_dataset("events", data=ev)
        g.create_dataset("image_raw_event_inds", data=np.searchsorted(ev[:, 2], ts))
        g.create_dataset("imu", data=rng.randn(50, 6))
        g.create_dataset("imu_ts", data=np.linspace(0, ts[-1], 50))
    return path


def _packets(out_dir):
    names = sorted(os.listdir(out_dir))
    pkts = []
    for n in names:
        with open(os.path.join(out_dir, n), "rb") as f:
            pkts.append(pickle.load(f))
    return names, pkts


def test_packets_match_jax(recording, tmp_path):
    variables = fill_variables(
        lambda: jffn.FastFlowNet().init(jax.random.key(0), jnp.zeros((1, 64, 64, 6))), 0)
    # the JAX calculator jitted: the same function, without the op-by-op
    # compiles of an eager first call at each batch size
    call = jax.jit(jffn.OpticalFlowCalculator.__call__, static_argnums=0)
    with mock.patch.object(jffn.OpticalFlowCalculator, "__call__", call):
        n_jax = jmvsec.convert_mvsec_h5(recording, str(tmp_path / "jax"),
                                        pair_flow_fn=jmvsec.fastflownet_pair_flow(variables))
    # the port through its command line, weights from a .pt
    ckpt = str(tmp_path / "ffn.pt")
    torch.save(fastflownet_from_jax_variables(variables), ckpt)
    n = mvsec.main(["-i", recording, "-o", str(tmp_path / "torch"), "--fastflownet_ckpt", ckpt,
                    "--device", "cpu"])
    assert n == n_jax == 2

    names_j, want = _packets(tmp_path / "jax")
    names_t, got = _packets(tmp_path / "torch")
    assert names_t == names_j == ["synth_data_left_00000.pkl", "synth_data_left_00001.pkl"]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("images", "accelerometers", "gyroscopes", "timestamps"):
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
        assert len(g["events"]) == len(w["events"]) == 16
        for eg, ew in zip(g["events"], w["events"]):
            assert eg.dtype == ew.dtype and eg.tobytes() == ew.tobytes()
        for k in ("optical_flow", "acc_flow"):
            assert g[k].shape == w[k].shape == (16, 2, H, W) and g[k].dtype == np.float32
            scale = float(np.abs(w[k]).max())
            assert scale > 0 and float(np.abs(g[k] - w[k]).max()) <= FLOW_TOL * scale, k
    # the file's first frame has no predecessor: its acc_flow is the
    # forward flow alone; later frames add the backward flow
    np.testing.assert_array_equal(got[0]["acc_flow"][0], got[0]["optical_flow"][0])
    assert not np.allclose(got[0]["acc_flow"][1], got[0]["optical_flow"][1])
    assert not np.allclose(got[1]["acc_flow"][0], got[1]["optical_flow"][0])


def test_exporters_match_jax(recording, tmp_path):
    for pkg, name in ((jmvsec, "jax"), (mvsec, "torch")):
        d = tmp_path / name
        pkg.events_to_txt(recording, str(d / "txt"))
        assert pkg.raw_to_hdrnet_input(recording, str(d / "hdr")) == N_FRAMES
    for sub in ("txt", "hdr"):
        files = sorted(os.listdir(tmp_path / "jax" / sub))
        assert files and sorted(os.listdir(tmp_path / "torch" / sub)) == files
        for f in files:
            assert ((tmp_path / "torch" / sub / f).read_bytes()
                    == (tmp_path / "jax" / sub / f).read_bytes()), f

    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (H, W)).astype(np.uint8)
    for fn in ("linearize_image", "gray_to_hdr_input"):
        a, b = getattr(mvsec, fn)(img), getattr(jmvsec, fn)(img)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), fn
    imgs = rng.randint(0, 255, (3, H, W)).astype(np.uint8)
    a = mvsec.farneback_flow(imgs[:-1], imgs[1:])
    assert a.tobytes() == jmvsec.farneback_flow(imgs[:-1], imgs[1:]).tobytes()
