"""The port's small modules against the JAX package's: the physical
attention (byte-identical), the image gradients and the blurred pair
gradient (within 1e-6 of the largest), `events.from_recarray`,
`pipeline/render.render_event_frames` on the device path (64 frames and
fewer) and the numpy one (more), the native stream packer and sort check
(the library and the numpy fallback), and the ported `gen_phy_att` and
`time_voxel_stat_calc` tools (the same packets and the same report as the
root tools)."""

import contextlib
import importlib.util
import io
import os
import pickle
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from v2ce_toolbox_tpu import events as jevents
from v2ce_toolbox_tpu.io import native as jnative
from v2ce_toolbox_tpu.pipeline.render import render_event_frames as jrender
from v2ce_toolbox_tpu.utils import image_derivative as jid
from v2ce_toolbox_tpu.utils import physical_att as jatt
from v2ce_toolbox_tpu_torch import events
from v2ce_toolbox_tpu_torch.data.dummy_data_gen import generate
from v2ce_toolbox_tpu_torch.io import native
from v2ce_toolbox_tpu_torch.pipeline.render import render_event_frames
from v2ce_toolbox_tpu_torch.tools import gen_phy_att, time_voxel_stat_calc
from v2ce_toolbox_tpu_torch.utils import image_derivative as tid
from v2ce_toolbox_tpu_torch.utils import physical_att as tatt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-6


def _events(n, h, w, seed):
    rng = np.random.default_rng(seed)
    ev = np.zeros(n, events.EVENT_DTYPE)
    ev["timestamp"] = np.sort(rng.integers(0, 33_000, n))
    ev["x"], ev["y"] = rng.integers(0, w, n), rng.integers(0, h, n)
    ev["polarity"] = rng.integers(0, 2, n)
    return ev


@pytest.mark.parametrize("advanced", [False, True])
def test_physical_attention_byte_identical(advanced):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 2, 36, 44)).astype(np.float64)
    evs = [_events(500 + 100 * i, 36, 44, i) for i in range(3)]
    got = tatt.physical_attention_batch_generation(evs, frames, 8, advanced=advanced)
    want = jatt.physical_attention_batch_generation(evs, frames, 8, advanced=advanced)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.shape == (3, 5, 6) and got.max() > 0
    plain = np.stack([evs[0]["timestamp"], evs[0]["x"], evs[0]["y"], evs[0]["polarity"]], 1)
    assert (tatt.physical_attention_generation(plain, frames[0]).tobytes()
            == jatt.physical_attention_generation(plain, frames[0]).tobytes())
    assert (tatt.gen_top_k_mask(got[0], 4) == jatt.gen_top_k_mask(want[0], 4)).all()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("shape", [(2, 16, 18, 1), (1, 20, 23, 3)])
def test_image_gradients(shape):
    rng = np.random.RandomState(1)
    a = rng.rand(*shape).astype(np.float32)
    b = rng.rand(*shape).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [(tid.batch_img_gradient(ta), jid.batch_img_gradient(ja)),
             (tid.gaussian_blur(ta), jid.gaussian_blur(ja)),
             (tid.gaussian_blur(ta, 5, 1.5), jid.gaussian_blur(ja, 5, 1.5)),
             (tid.get_batch_double_blurred_image_gradient(ta, tb),
              jid.get_batch_double_blurred_image_gradient(ja, jb)),
             (tid.batch_img_residual(ta, tb), jid.batch_img_residual(ja, jb))]
    for got, want in pairs:
        assert tuple(got.shape) == shape
        assert _rel(got.numpy(), np.asarray(want)) <= GRAD_TOL


def test_from_recarray():
    """Against JAX on the CPU; without a device it goes to the card, so on
    a host without one it raises."""
    rec = _events(50, 260, 346, 2)
    for cap in (64, 50, 20):
        got = events.from_recarray(rec, cap, device="cpu")
        want = jevents.from_recarray(rec, cap)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    if torch.cuda.is_available():
        assert events.from_recarray(rec, 8).t_us.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            events.from_recarray(rec, 8)


@pytest.mark.parametrize("frames,keep_polarity", [(3, True), (3, False), (64, True),
                                                  (65, True), (65, False)])
def test_render_event_frames(frames, keep_polarity):
    """The device path at 64 frames and fewer, numpy beyond; voxels with
    float values, some bound by the ceiling."""
    rng = np.random.RandomState(frames)
    vox = (rng.rand(frames, 6, 7, 20) * 3).astype(np.float32)
    vox[vox < 1.2] = 0
    vox[0, 0, 0] = 9.0
    kw = dict(ceil=10.0, upper_bound_percentile=98, keep_polarity=keep_polarity)
    got = render_event_frames(torch.from_numpy(vox), **kw)
    want = np.asarray(jrender(jnp.asarray(vox) if frames <= 64 else vox, **kw))
    assert got.dtype == np.uint8 and got.shape == (frames, 6, 7, 3)
    np.testing.assert_array_equal(got, want)


def _soa(b=5, e=64, seed=0):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, e, b).astype(np.int32)
    t = np.full((b, e), np.iinfo(np.int32).max, np.int32)
    x, y = np.zeros((b, e), np.int16), np.zeros((b, e), np.int16)
    p = np.zeros((b, e), np.int8)
    for f in range(b):
        n = counts[f]
        t[f, :n] = np.sort(rng.randint(0, 33000, n))
        x[f, :n], y[f, :n], p[f, :n] = rng.randint(0, 346, n), rng.randint(0, 260, n), \
            rng.randint(0, 2, n)
    return t, x, y, p, counts, (np.arange(b) * 33333).astype(np.int64)


def test_pack_event_stream_and_first_inversion():
    """The library and the numpy fallback against the JAX package's
    packer, byte for byte, and the sort check on both."""
    assert native.native_available()
    args = _soa()
    want = jnative.pack_event_stream(*args)
    lib = native.pack_event_stream(*args)
    with mock.patch.object(native, "_load", lambda: None):
        fallback = native.pack_event_stream(*args)
        assert native.first_inversion(fallback) == -1
        bad = fallback.copy()
        bad["timestamp"][7] = -1
        assert native.first_inversion(bad) == 7
    assert lib.dtype == want.dtype == events.EVENT_DTYPE
    assert lib.tobytes() == want.tobytes() == fallback.tobytes()
    assert native.pack_event_stream(*args, num_threads=1).tobytes() == want.tobytes()
    assert native.first_inversion(lib) == jnative.first_inversion(want) == -1
    assert native.first_inversion(bad) == jnative.first_inversion(bad) == 7


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("advanced", [False, True])
def test_tools_match_the_root_tools(tmp_path, advanced):
    """gen_phy_att rewrites the packets as the root tool does (the same
    physical_att bytes, the same output), and time_voxel_stat_calc prints
    the same report."""
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    generate(str(ours), num_packets=3, height=32, width=40, events_per_frame=200)
    shutil.copytree(ours, theirs)
    flags = ["--workers", "2"] + (["--advanced", "--ceiling", "4"] if advanced else [])
    said = _run(gen_phy_att.main, ["--data_dir", str(ours)] + flags)
    root = _root_tool("gen_phy_att")
    with mock.patch.object(sys, "argv", ["gen_phy_att.py", "--data_dir", str(theirs)] + flags):
        root_said = _run(lambda _: root.main(), None)
    assert said == root_said and "rewrote physical_att in 3 packets" in said
    for f in sorted(os.listdir(ours)):
        with open(ours / f, "rb") as a, open(theirs / f, "rb") as b:
            pa, pb = pickle.load(a), pickle.load(b)
        assert pa["physical_att"].tobytes() == pb["physical_att"].tobytes()
        assert pa["physical_att"].shape == (16, 4, 5)
    argv = ["--data_dir", str(ours), "--max_files", "2", "--num_bins", "5"]
    report = _run(time_voxel_stat_calc.main, argv)
    root = _root_tool("time_voxel_stat_calc")
    with mock.patch.object(sys, "argv", ["time_voxel_stat_calc.py"] + argv):
        assert report == _run(lambda _: root.main(), None)
    assert report.startswith("files: 2  nonzero voxels: ")
