"""The port's EventGAN data subtree against the JAX package's: the host
normalisation exact against the numpy one, the device twin exact against
the jnp one (also at an n where the f32 and f64 k indices differ, so the
two pick other order statistics), `scale_events` exact against the JAX
function run op by op and within two f32 ulps of the volume's extent of it
jitted (XLA:CPU then contracts two multiply-adds into FMAs), and `MVSECSequence` items, the
concatenation and the weighted sampler byte-identical on a temporary h5
file, from the h5 read and from the arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)
from v2ce_toolbox_tpu.data import eventgan as jeg
from v2ce_toolbox_tpu_torch.data import eventgan as eg

# 0.98 * 267501 is 262150.98 in f64 and 262151.0 in f32
BOUNDARY_N = 267501


def _volume(seed, shape=(6, 16, 20)):
    rng = np.random.default_rng(seed)
    vol = (rng.gamma(0.3, 1.0, size=shape) * rng.choice([-1, 1], size=shape)).astype(np.float32)
    vol[np.abs(vol) < 0.4] = 0.0
    return vol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_event_volume(seed):
    vol = _volume(seed)
    host = eg.normalize_event_volume(vol.copy())
    assert host.tobytes() == jeg.normalize_event_volume(vol.copy()).tobytes()
    dev = eg.normalize_event_volume_torch(torch.from_numpy(vol)).numpy()
    assert dev.tobytes() == np.asarray(jeg.normalize_event_volume_jnp(jnp.asarray(vol))).tobytes()
    zero = np.zeros((4, 5, 5), np.float32)
    assert eg.normalize_event_volume(zero.copy()).tobytes() == zero.tobytes()
    assert eg.normalize_event_volume_torch(torch.from_numpy(zero)).numpy().tobytes() \
        == zero.tobytes()


def test_normalize_event_volume_at_the_f32_boundary():
    """n = 267501 nonzeros, all distinct and positive, so the 98% order
    statistic sets the scale: the host takes k = 262150 (f64), the device
    twin k = 262151 (f32), each as its JAX counterpart does."""
    rng = np.random.default_rng(3)
    vol = np.zeros(18 * 128 * 128, np.float32)
    vol[rng.permutation(vol.size)[:BOUNDARY_N]] = rng.permutation(BOUNDARY_N) + 1.0
    vol = vol.reshape(18, 128, 128)
    host = eg.normalize_event_volume(vol.copy())
    dev = eg.normalize_event_volume_torch(torch.from_numpy(vol)).numpy()
    assert host.tobytes() == jeg.normalize_event_volume(vol.copy()).tobytes()
    assert dev.tobytes() == np.asarray(jeg.normalize_event_volume_jnp(jnp.asarray(vol))).tobytes()
    assert host.max() == 1.0 and dev.max() == 1.0
    assert float(np.float32(262151) / np.float32(262152)) in dev
    assert float(np.float32(262150) / np.float32(262151)) in host
    assert host.tobytes() != dev.tobytes()


@pytest.mark.parametrize("h,volume_size", [(8, (64, 64, 18)), (24, (100, 100, 9)),
                                           (32, (320, 320, 10))])
def test_scale_events(h, volume_size):
    ev = np.random.default_rng(h).uniform(-1, 1, size=(2, h, h, 3, 4)).astype(np.float32)
    got = eg.scale_events(torch.from_numpy(ev), volume_size).numpy()
    want = np.asarray(jeg.scale_events(jnp.asarray(ev), volume_size))
    assert got.shape == (2, h * h * 3, 4)
    assert got.tobytes() == want.tobytes()
    # jitted, XLA:CPU contracts the grid's multiply-add and the output's
    # into FMAs: each moves a coordinate by at most one f32 ulp of the
    # volume's extent (that of 1 for p)
    jitted = np.asarray(jax.jit(lambda e: jeg.scale_events(e, volume_size))(jnp.asarray(ev)))
    extent = np.asarray((*volume_size, 1), np.float32)
    assert (np.abs(got - jitted) <= 2 * np.spacing(extent)).all()


def test_scale_events_is_differentiable():
    ev = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 4, 4, 2, 4))
                          .astype(np.float32)).requires_grad_(True)
    eg.scale_events(ev, (16, 16, 9)).sum().backward()
    np.testing.assert_array_equal(ev.grad[0, 0, 0, 0].numpy(), [2.0, 2.0, 4.0, 1.0])


def test_gamma_gain_and_illumination_draws():
    img = np.linspace(-1, 1, 33, dtype=np.float32).reshape(1, 3, 11)
    for gamma, gain in ((1.0, 1.0), (0.8, 1.2), (1.2, 10.0)):
        assert eg.transform_gamma_gain(img, gamma, gain).tobytes() == \
            jeg.transform_gamma_gain(img, gamma, gain).tobytes()
    a = eg.apply_illum_augmentation(img, -img, np.random.default_rng(4))
    b = jeg.apply_illum_augmentation(img, -img, np.random.default_rng(4))
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def _recording(n_images=40, h=32, w=48, ev_per_gap=400, seed=0):
    """An MVSEC davis/left group's arrays (tests/test_eventgan.py's)."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n_images, h, w)).astype(np.uint8)
    ts = 10.0 + np.arange(n_images) / 25.0
    evs, inds, count = [], [], 0
    for i in range(n_images - 1):
        inds.append(count)
        t = np.sort(rng.uniform(ts[i], ts[i + 1], ev_per_gap))
        evs.append(np.stack([rng.integers(0, w, ev_per_gap), rng.integers(0, h, ev_per_gap), t,
                             rng.choice([-1, 1], ev_per_gap)], axis=1))
        count += ev_per_gap
    inds.append(count)
    return images, ts, np.asarray(inds, np.int64), np.concatenate(evs).astype(np.float64)


def _write_h5(path, arrays):
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("davis").create_group("left")
        for k, a in zip(("image_raw", "image_raw_ts", "image_raw_event_inds", "events"),
                        arrays):
            g[k] = a
    return str(path)


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("train", [False, True])
def test_mvsec_sequence_items(tmp_path, train):
    """Every item of a sequence, in train mode (random crop, skip, flips,
    illumination, resampling under min_events) and in eval, from the h5
    read and from the arrays, against the JAX sequence's."""
    arrays = _recording(ev_per_gap=150 if train else 400)
    path = _write_h5(tmp_path / "seq.h5", arrays)
    cfg = eg.EventGANDataConfig(image_size=(16, 24), top_left=(3, 5), start_time=0.0,
                                max_skip_frames=4, n_time_bins=3, min_events=100)
    jcfg = jeg.EventGANDataConfig(**vars(cfg))
    want = jeg.MVSECSequence(jcfg, path=path, train=train, seed=7)
    got = eg.MVSECSequence(cfg, path=path, train=train, seed=7)
    arr = eg.MVSECSequence.from_arrays(cfg, *arrays, train=train, seed=7)
    assert len(got) == len(arr) == len(want) == 40 - 4 - 1
    for i in range(len(want)):
        w = want[i]
        _same_item(got[i], w)
        _same_item(arr[i], w)
    assert np.abs(w["event_volume"]).max() == 1.0


def test_weighted_concat_and_sampler(tmp_path):
    p1 = _write_h5(tmp_path / "indoor_flying1.h5", _recording(n_images=30, seed=1))
    p2 = _write_h5(tmp_path / "outdoor_day1.h5", _recording(n_images=40, seed=2))
    listing = tmp_path / "files.txt"
    listing.write_text(f"{p1} 0.0\n{p2} 0.5\n")
    for train in (False, True):
        cfg = eg.EventGANDataConfig(image_size=(16, 24), max_skip_frames=4, n_time_bins=2)
        ds, sampler = eg.weighted_concat(str(listing), cfg, train=train, seed=3)
        jds, jsampler = jeg.weighted_concat(str(listing), jeg.EventGANDataConfig(**vars(cfg)),
                                            train=train, seed=3)
        assert len(ds) == len(jds) and list(ds.offsets) == list(jds.offsets)
        idx = list(iter(sampler))
        assert idx == list(iter(jsampler))
        for i in idx[:6] + [int(ds.offsets[1]) - 1, int(ds.offsets[1])]:
            _same_item(ds[i], jds[i])
    w = eg.sequence_weights([p1, p2], [25, 35])
    assert w.tobytes() == jeg.sequence_weights([p1, p2], [25, 35]).tobytes()
    with pytest.raises(AssertionError):
        eg.WeightedRandomSampler(3, np.ones(4))
