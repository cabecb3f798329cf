"""The port's data modules (`v2ce_toolbox_tpu_torch/data/`, `utils/v2e.py`)
against the JAX package's, on the same seeded events and packets: the
numpy voxel converters, `lin_log`, the dummy packets, `EventPackDataset`
items and `iterate_batches` identical; the torch
`gen_discretized_event_volume` within 1e-6 of the jnp one (scatter-adds
in another order); `device_prefetch` hands the same values over as
tensors."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from v2ce_toolbox_tpu.data import dummy_data_gen as jdummy
from v2ce_toolbox_tpu.data import event_pack_dataset as jds
from v2ce_toolbox_tpu.data import loader as jloader
from v2ce_toolbox_tpu.data import voxelize as jvox
from v2ce_toolbox_tpu.utils import v2e as jv2e
from v2ce_toolbox_tpu_torch.data import dummy_data_gen, event_pack_dataset, loader, voxelize
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.io import native
from v2ce_toolbox_tpu_torch.utils import v2e
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

H, W = 24, 30


def _events(n, seed):
    rng = np.random.RandomState(seed)
    ev = np.zeros((n,), dtype=EVENT_DTYPE)
    ev["timestamp"] = np.sort(rng.randint(0, 100000, (n,)))
    ev["x"] = rng.randint(0, W, (n,))
    ev["y"] = rng.randint(0, H, (n,))
    ev["polarity"] = rng.randint(0, 2, (n,))
    return ev


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# 300 events take np.add.at, 5000 the native splat
@pytest.mark.parametrize("n", [300, 5000])
def test_numpy_voxelizers_identical(n):
    assert native.native_available()        # the splat is built, not skipped
    ev = _events(n, n)
    _same(voxelize.gen_discretized_event_volume_np(ev, (20, H, W)),
          jvox.gen_discretized_event_volume_np(ev, (20, H, W)))
    _same(voxelize.structured_events_to_voxel_grid(ev, 10, W, H),
          jvox.structured_events_to_voxel_grid(ev, 10, W, H))
    for a, b in zip(voxelize.structured_events_to_voxel_stat(ev, 10, W, H),
                    jvox.structured_events_to_voxel_stat(ev, 10, W, H)):
        _same(a, b)
    _same(voxelize.accumulate_frame(ev, W, H), jvox.accumulate_frame(ev, W, H))
    rows = np.stack([ev["timestamp"], ev["x"], ev["y"], ev["polarity"]], 1).astype(np.float64)
    _same(voxelize.events_to_voxel_grid_np(rows, 10, W, H),
          jvox.events_to_voxel_grid_np(rows, 10, W, H))
    frames = np.random.RandomState(n).rand(3, H, W).astype(np.float32) * 255
    _same(v2e.gen_log_frame_residual_batch(frames), jv2e.gen_log_frame_residual_batch(frames))


@pytest.mark.parametrize("bounds", [None, (1000.0, 90000.0)])
def test_device_voxelizer_matches_jnp(bounds):
    ev = _events(400, 5)
    cap = 512
    valid = np.zeros(cap, bool)
    valid[:len(ev)] = True
    rng = np.random.RandomState(6)

    def pad(a):      # padding slots hold garbage, which the mask must drop
        return np.concatenate([a, rng.randint(0, 20, cap - len(ev)).astype(a.dtype)])

    fields = [pad(ev["timestamp"].astype(np.int32)), pad(ev["x"].astype(np.int32)),
              pad(ev["y"].astype(np.int32)), pad(ev["polarity"].astype(np.int32))]
    kw = {} if bounds is None else dict(t_min=bounds[0], t_max=bounds[1])
    want = np.asarray(jvox.gen_discretized_event_volume(
        *map(jnp.asarray, fields), jnp.asarray(valid), (20, H, W), **kw))
    got = voxelize.gen_discretized_event_volume(
        *map(torch.from_numpy, fields), torch.from_numpy(valid), (20, H, W), **kw)
    assert got.dtype == torch.float32 and got.shape == (20, H, W)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(float(got.sum()), len(ev), rtol=1e-5)


@pytest.fixture(scope="module")
def packets(tmp_path_factory):
    """Dummy packets written by both packages from one seed."""
    root = tmp_path_factory.mktemp("packets")
    kw = dict(num_packets=6, seed=3, height=H, width=W, events_per_frame=50)
    dummy_data_gen.generate(str(root / "torch"), **kw)
    jdummy.generate(str(root / "jax"), **kw)
    return root


def test_dummy_packets_identical(packets):
    names = sorted(os.listdir(packets / "jax"))
    assert len(names) == 6 and sorted(os.listdir(packets / "torch")) == names
    for n in names:
        assert (packets / "torch" / n).read_bytes() == (packets / "jax" / n).read_bytes()


@pytest.mark.parametrize("mode,kw", [
    ("train", dict(random_flip=True, flip_y_prob=0.5, illum_aug=True)),
    ("test", dict(seq_len=8)),
])
def test_dataset_items_identical(packets, mode, kw):
    # seeded with seed + hash(mode): both datasets live in this process
    ds = event_pack_dataset.EventPackDataset(mode, str(packets / "jax"), **kw)
    ref = jds.EventPackDataset(mode, str(packets / "jax"), **kw)
    assert len(ds) == len(ref) > 0
    for i in range(len(ds)):
        a, b = ds[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])


def test_batches_identical_and_prefetched(packets):
    # no random augmentation here: the worker threads would draw from the
    # dataset's one RandomState in whatever order they run
    ds = event_pack_dataset.EventPackDataset("train", str(packets / "jax"))
    ref = jds.EventPackDataset("train", str(packets / "jax"))
    got = list(loader.iterate_batches(ds, 2, seed=1, num_workers=2))
    want = list(jloader.iterate_batches(ref, 2, seed=1, num_workers=2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    moved = list(loader.device_prefetch(iter(got), device="cpu"))
    assert len(moved) == 2
    for a, b in zip(moved, got):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            _same(a[k].numpy(), b[k])
    assert moved[0]["voxels"].shape == (2, 16, H, W, 20)
