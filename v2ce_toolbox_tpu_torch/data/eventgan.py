"""EventGAN data subtree: the reference's legacy
`train/scripts/data/data_eventgan/` loader (event_loader.py,
event_utils.py, configs.py, base_options.py), the port of
`v2ce_toolbox_tpu/data/eventgan.py`.

- volume building uses data/voxelize.gen_discretized_event_volume_np (the
  subtree's gen_discretized_event_volume, event_utils.py:51-106, is the
  same floor/ceil splat recipe).
- normalize_event_volume: 2%/98% nonzero-kth-value clamp-and-scale
  (event_loader.py:174-188), on the host in numpy (Python-float k
  indices), and its device twin normalize_event_volume_torch (the JAX
  package's jnp twin: k indices from 0.02 * n in f32). The two can pick
  other order statistics at an n where the f32 and f64 products truncate
  differently.
- scale_events: EventGAN generator output -> absolute event coordinates
  (event_utils.py:183-210), differentiable, where its tensor is.
- MVSECSequence: frame-pair + crop-window sampler over the MVSEC h5
  layout (event_loader.py:11-262) producing {prev,next} images in
  [-1, 1] and the normalized event volume, with flip and gamma/gain
  illumination augmentation. The h5 read (`_load`) is apart from the step
  that takes its four arrays (`from_arrays`), for hosts without h5py.
- weighted_concat / WeightedRandomSampler: sqrt-length dataset weights,
  indoor x2, per-element inverse weights, multinomial index stream
  (event_loader.py:265-305).

Host-side work is numpy, with the JAX package's np.random.Generator draws
in the same order, so items match its items byte for byte. Timestamps are
quantized to integer µs at load.
"""

from __future__ import annotations

import os.path as op
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE


@dataclass
class EventGANDataConfig:
    """Loader-relevant defaults of the reference's argparse config
    (configs.py:71-104, base_options.py)."""

    image_size: Tuple[int, int] = (256, 320)   # crop (H, W)
    top_left: Tuple[int, int] = (2, 13)        # eval-crop corner
    start_time: float = 45.0                   # seconds skipped at start
    max_skip_frames: int = 6
    n_time_bins: int = 9
    flip_x: float = 0.5
    flip_y: float = 0.5
    appearance_augmentation: bool = True
    normalize_events: bool = True
    min_events: int = 100                      # event_loader.py:209
    which: str = "left"


def normalize_event_volume(vol: np.ndarray) -> np.ndarray:
    """2%/98% nonzero-kth-value clamp-and-scale
    (reference event_loader.py:174-188): k-th SMALLEST nonzero value at
    k = max(int(q * n_nonzero), 1), clamp to [-max_val, max_val], divide.
    Identity when the volume is all zero."""
    flat = vol.reshape(-1)
    nz = flat[flat != 0]
    if nz.size == 0:
        return vol
    k_lo = max(int(0.02 * nz.size), 1)
    k_hi = max(int(0.98 * nz.size), 1)
    part = np.sort(nz)                        # exact kth values
    lower = part[k_lo - 1]
    upper = part[k_hi - 1]
    max_val = max(abs(lower), upper)
    return np.clip(vol, -max_val, max_val) / max_val


def normalize_event_volume_torch(vol: torch.Tensor) -> torch.Tensor:
    """Device twin of normalize_event_volume (the JAX package's
    normalize_event_volume_jnp): zeros sort to +inf, so the ascending
    sort's first n entries are the nonzero order statistics; the k indices
    are (0.02 * n) and (0.98 * n) in f32, truncated, as jnp computes them.
    No host sync: an all-zero volume passes through by a select."""
    flat = vol.reshape(-1).float()
    nz = flat != 0
    n = nz.sum().to(torch.int32)
    s = torch.sort(torch.where(nz, flat, torch.inf)).values
    nf = n.float()

    def kth(q):
        k = torch.clamp((torch.tensor(q, dtype=torch.float32, device=vol.device) * nf)
                        .to(torch.int32), min=1)
        return s[torch.clamp(k - 1, min=0).long()]

    lower, upper = kth(0.02), kth(0.98)
    max_val = torch.maximum(lower.abs(), upper)
    out = torch.clamp(vol, -max_val, max_val) / max_val
    return torch.where(n > 0, out, vol)


def scale_events(events: torch.Tensor, volume_size: Sequence[int]) -> torch.Tensor:
    """EventGAN generator decode (reference event_utils.py:183-210):
    network output (B, H, W, N, 4) in [-1, 1], per-cell relative [x, y, t,
    p], scaled and offset to absolute coordinates in [0, volume_size[0]] x
    [0, volume_size[1]] x [0, volume_size[2]] x [-1, 1], flattened to (B,
    H*W*N, 4). Differentiable.

    The reference's grid assumes square crops (one cell scale from
    volume_size[0] / H, the meshgrid indexed 'ij'); kept as it is. Each
    product and sum rounds on its own, as the JAX function does when it
    runs op by op; XLA:CPU contracts the grid's and the output's
    multiply-adds into FMAs when the function is jitted, one f32 ulp away
    at most on a coordinate."""
    b, h, w, n, _ = events.shape
    dev = events.device
    scale = volume_size[0] / h
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    half_t = torch.tensor(scale / 2, dtype=torch.float32, device=dev)
    x_range = torch.arange(w, dtype=torch.float32, device=dev) * scale_t + half_t
    y_range = torch.arange(h, dtype=torch.float32, device=dev) * scale_t + half_t
    x_offset, y_offset = torch.meshgrid(x_range, y_range, indexing="ij")
    t_scale = (volume_size[2] - 1) / 2.0
    t_offset = torch.full(x_offset.shape, t_scale, dtype=torch.float32, device=dev)
    p_offset = torch.zeros(x_offset.shape, dtype=torch.float32, device=dev)
    offset = torch.stack((x_offset, y_offset, t_offset, p_offset), dim=-1)[None, :, :, None, :]
    output_scale = torch.tensor((scale / 2, scale / 2, t_scale, 1.0), dtype=torch.float32,
                                device=dev).reshape(1, 1, 1, 1, 4)
    out = events * output_scale + offset
    return out.reshape(b, -1, 4)


def transform_gamma_gain(image: np.ndarray, gamma: float,
                         gain: float) -> np.ndarray:
    """Gamma + gain on a [-1, 1] image (event_loader.py:198-203)."""
    image = (1.0 + image) / 2.0
    image = gain * np.power(image, gamma)
    image = (image - 0.5) * 2.0
    return np.clip(image, -1.0, 1.0)


def apply_illum_augmentation(prev_image: np.ndarray, next_image: np.ndarray,
                             rng: np.random.Generator,
                             gain_min: float = 0.8, gain_max: float = 1.2,
                             gamma_min: float = 0.8, gamma_max: float = 1.2):
    """One shared (gamma, gain) draw for the frame pair
    (event_loader.py:190-196)."""
    gamma = gamma_min + rng.random() * (gamma_max - gamma_min)
    gain = gain_min + rng.random() * (gain_max - gain_min)
    return (transform_gamma_gain(prev_image, gamma, gain),
            transform_gamma_gain(next_image, gamma, gain))


class MVSECSequence:
    """Frame-pair sampler over one MVSEC *_data.hdf5 recording
    (reference event_loader.py:11-262).

    Items are dicts with prev/next images ((1, H, W) float32 in [-1, 1],
    pre-augmentation copies under *_gt), their timestamps, and the
    (2 * n_time_bins, H, W) discretized event volume of the crop window.
    Training mode draws a random crop, a random frame skip in
    [1, max_skip_frames], resamples indices until the inter-frame event
    count reaches min_events, and applies flip + illumination
    augmentation; eval mode is deterministic (fixed top_left crop,
    skip 2, no augmentation)."""

    def __init__(self, config: EventGANDataConfig, path: str,
                 train: bool = True, start_time: Optional[float] = None,
                 seed: int = 0):
        self._setup(config, path, train, start_time, seed)
        self._load()

    @classmethod
    def from_arrays(cls, config: EventGANDataConfig, images: np.ndarray,
                    images_ts: np.ndarray, image_to_event: np.ndarray,
                    events: np.ndarray, path: str = "", train: bool = True,
                    start_time: Optional[float] = None, seed: int = 0) -> "MVSECSequence":
        """A sequence over the four arrays of an MVSEC `davis/<which>`
        group (image_raw, image_raw_ts, image_raw_event_inds, events), as
        `_load` reads them: the same items, without h5py."""
        seq = cls.__new__(cls)
        seq._setup(config, path, train, start_time, seed)
        seq._set_arrays(images, images_ts, image_to_event, events)
        return seq

    def _setup(self, config, path, train, start_time, seed):
        self.cfg = config
        self.path = path
        self.train = train
        self.start_time = (config.start_time if start_time is None
                           else start_time)
        self.flip_x = config.flip_x if train else 0.0
        self.flip_y = config.flip_y if train else 0.0
        self.rng = np.random.default_rng(seed)

    def _load(self):
        import h5py

        with h5py.File(self.path, "r") as f:
            g = f["davis"][self.cfg.which]
            arrays = [np.array(g[k]) for k in ("image_raw", "image_raw_ts",
                                                "image_raw_event_inds", "events")]
        self._set_arrays(*arrays)

    def _set_arrays(self, images, images_ts, image_to_event, events):
        self.images = np.asarray(images)                   # (N, H, W)
        self.images_ts = np.asarray(images_ts)             # (N,) seconds
        self.image_to_event = np.asarray(image_to_event).astype(np.int64)
        self.events = np.asarray(events)                   # (M, 4)
        self.raw_image_size = self.images.shape[1:]
        self.start_frame = int(np.searchsorted(
            self.images_ts, self.start_time + self.images_ts[0]))
        self.num_images = self.images.shape[0]

    def __len__(self) -> int:
        return (self.num_images - self.start_frame
                - self.cfg.max_skip_frames - 1)

    def get_prev_next_inds(self, ind: int) -> Tuple[int, int]:
        pind = self.start_frame + ind
        if self.train:
            cind = (self.start_frame + ind + 1
                    + int((self.cfg.max_skip_frames - 1) * self.rng.random()))
        else:
            cind = pind + 2
        return pind, cind

    def get_box(self):
        top_left = tuple(self.cfg.top_left)
        hs, ws = self.cfg.image_size
        if self.train:
            top = int(self.rng.random() * (self.raw_image_size[0] - 1 - hs))
            left = int(self.rng.random() * (self.raw_image_size[1] - 1 - ws))
            top_left = (top, left)
        return top_left, (top_left[0] + hs, top_left[1] + ws)

    def get_image(self, ind: int, bbox):
        (top, left), (bot, right) = bbox
        image = self.images[ind][top:bot, left:right, None]
        image = image.transpose(2, 0, 1).astype(np.float32) / 255.0
        return (image - 0.5) * 2.0, float(self.images_ts[ind])

    def count_events(self, pind: int, cind: int) -> int:
        return int(self.image_to_event[cind] - self.image_to_event[pind])

    def get_events(self, pind: int, cind: int, bbox) -> np.ndarray:
        """Crop-window events as structured EVENT_DTYPE, coordinates
        shifted to the crop frame, timestamps rebased to the window's
        first event in µs (event_loader.py:128-151)."""
        (top, left), (bot, right) = bbox
        peind = max(int(self.image_to_event[pind]), 0)
        ceind = int(self.image_to_event[cind])
        ev = self.events[peind:ceind]
        mask = ((ev[:, 1] >= top) & (ev[:, 1] < bot)
                & (ev[:, 0] >= left) & (ev[:, 0] < right))
        ev = ev[mask]
        out = np.zeros(len(ev), dtype=EVENT_DTYPE)
        if len(ev):
            out["x"] = (ev[:, 0] - left).astype(np.int16)
            out["y"] = (ev[:, 1] - top).astype(np.int16)
            t = ev[:, 2] - ev[:, 2].min()
            out["timestamp"] = np.round(t * 1e6).astype(np.int64)
            out["polarity"] = (ev[:, 3] > 0).astype(np.int8)
        return out

    def get_single_item(self, ind: int) -> dict:
        cfg = self.cfg
        if self.train:
            # resample until the frame pair has enough events
            # (event_loader.py:208-216 with its fixed 100 threshold);
            # bounded, unlike the reference, so a recording where no pair
            # qualifies raises instead of hanging a loader worker forever
            for attempt in range(10 * max(len(self), 1)):
                if self.count_events(ind, ind + 1) >= cfg.min_events:
                    break
                ind = int(self.rng.integers(0, len(self)))
            else:
                raise ValueError(
                    f"{self.path}: no frame pair reaches min_events="
                    f"{cfg.min_events}")
        pind, cind = self.get_prev_next_inds(ind)
        bbox = self.get_box()

        next_image, next_image_ts = self.get_image(cind, bbox)
        prev_image, prev_image_ts = self.get_image(pind, bbox)

        events = self.get_events(pind, cind, bbox)
        volume = gen_discretized_event_volume_np(
            events, (cfg.n_time_bins * 2, cfg.image_size[0],
                     cfg.image_size[1]))
        if cfg.normalize_events:
            volume = normalize_event_volume(volume)

        prev_gt, next_gt = prev_image, next_image
        if self.train:
            if self.rng.random() < self.flip_x:
                prev_image = np.flip(prev_image, axis=2)
                next_image = np.flip(next_image, axis=2)
            if self.rng.random() < self.flip_y:
                prev_image = np.flip(prev_image, axis=1)
                next_image = np.flip(next_image, axis=1)
            prev_gt, next_gt = prev_image, next_image
            if cfg.appearance_augmentation:
                prev_image, next_image = apply_illum_augmentation(
                    prev_image, next_image, self.rng)

        return {
            "prev_image": prev_image.copy(),
            "prev_image_gt": prev_gt.copy(),
            "prev_image_ts": prev_image_ts,
            "next_image": next_image.copy(),
            "next_image_gt": next_gt.copy(),
            "next_image_ts": next_image_ts,
            "event_volume": volume,
        }

    def __getitem__(self, ind: int) -> dict:
        return self.get_single_item(ind)


class WeightedRandomSampler:
    """Multinomial-with-replacement index stream over per-element weights
    (reference event_loader.py:265-281; weights need not sum to 1)."""

    def __init__(self, num_items: int, weights: np.ndarray, seed: int = 0):
        assert len(weights) == num_items
        self.num_items = num_items
        self.p = np.asarray(weights, np.float64)
        self.p = self.p / self.p.sum()
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_items

    def __iter__(self) -> Iterator[int]:
        return iter(self.rng.choice(self.num_items, size=self.num_items,
                                    replace=True, p=self.p))


@dataclass
class ConcatSequences:
    """ConcatDataset twin: flat indexing over a list of sequences."""

    datasets: List[MVSECSequence]
    offsets: np.ndarray = field(init=False)

    def __post_init__(self):
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, ind: int) -> dict:
        d = int(np.searchsorted(self.offsets, ind, side="right")) - 1
        return self.datasets[d][ind - int(self.offsets[d])]


def sequence_weights(paths: Sequence[str],
                     lengths: Sequence[int]) -> np.ndarray:
    """Per-element inverse weights of get_and_concat_datasets
    (event_loader.py:283-305): dataset weight = sqrt(len), doubled for
    'indoor' recordings; every element carries 1 / dataset_weight so the
    multinomial sampler evens out dataset sizes."""
    per_elem: List[float] = []
    for path, n in zip(paths, lengths):
        w = float(np.sqrt(n))
        if "indoor" in op.basename(path) or "indoor" in path:
            w *= 2.0
        per_elem += [w] * n
    return 1.0 / np.asarray(per_elem, np.float64)


def weighted_concat(path_file: str, config: EventGANDataConfig,
                    train: bool = True, seed: int = 0):
    """get_and_concat_datasets equivalent: `path_file` lines are
    '<h5_path> <start_time>'; returns (ConcatSequences,
    WeightedRandomSampler)."""
    paths: List[str] = []
    starts: List[float] = []
    with open(path_file) as f:
        for line in f.read().splitlines():
            if not line:
                break
            path, start = line.split(" ")
            paths.append(path)
            starts.append(float(start))
    ds = [MVSECSequence(config, path=p, train=train, start_time=s,
                        seed=seed + i)
          for i, (p, s) in enumerate(zip(paths, starts))]
    concat = ConcatSequences(ds)
    weights = sequence_weights(paths, [len(d) for d in ds])
    return concat, WeightedRandomSampler(len(concat), weights, seed=seed)
