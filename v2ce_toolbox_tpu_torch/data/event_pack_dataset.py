"""EventPackDataset — 16-frame pkl packets -> training batches.

Numpy re-design of the reference dataset
(reference: train/scripts/data/event_pack_dataset.py:19-117). Differences:

  - batches are channels-last: image_units (L, H, W, 2), voxels
    (L, H, W, 2*num_bins) with channel c = p*num_bins + bin;
  - the train/val/test split is a seeded shuffle of the packets found in
    data_dir (the reference hardcodes an external split pkl at
    event_pack_dataset.py:45; its dl_utils seeded splitter is the model,
    train/scripts/utils/dl_utils.py:7-54);
  - no torch DataLoader: `iterate_batches` in loader.py stacks host
    batches and `device_prefetch` copies them to the card.

A copy of `v2ce_toolbox_tpu/data/event_pack_dataset.py` (numpy only): the
same files, seed and mode give the same items. The augmentation stream is
seeded with `seed + hash(mode) % 1000`, as there; `hash` of a str depends
on PYTHONHASHSEED, so two processes agree only with one fixed value.
"""

from __future__ import annotations

import os
import os.path as op
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from v2ce_toolbox_tpu_torch.data.voxelize import gen_discretized_event_volume_np
from v2ce_toolbox_tpu_torch.utils.v2e import gen_log_frame_residual_batch

# Normalization constants (reference: event_pack_dataset.py:38-43)
FRAME_MEAN, FRAME_STD = 0.153, 0.165
OPTFLOW_MEAN = np.array([-0.0673, 0.0192], np.float32)
OPTFLOW_STD = np.array([1.7283, 1.8886], np.float32)
ACCFLOW_MEAN = np.array([420.4524, -3841.5618], np.float32)
ACCFLOW_STD = np.array([6386.6489, 4546.8569], np.float32)


def split_paths(
    data_dir: str,
    ratios: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 2333,
) -> Dict[str, List[str]]:
    """Seeded train/val/test split over the pkl packets in data_dir
    (reference: train/scripts/utils/dl_utils.py:7-54)."""
    paths = sorted(
        op.join(data_dir, f) for f in os.listdir(data_dir) if f.endswith(".pkl")
    )
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(paths))
    n_train = int(len(paths) * ratios[0])
    n_val = int(len(paths) * ratios[1])
    return {
        "train": [paths[i] for i in order[:n_train]],
        "val": [paths[i] for i in order[n_train:n_train + n_val]],
        "test": [paths[i] for i in order[n_train + n_val:]],
    }


def apply_illum_augmentation(
    image: np.ndarray,
    rng: np.random.RandomState,
    gain_range: Tuple[float, float] = (0.8, 1.2),
    gamma_range: Tuple[float, float] = (0.8, 1.2),
) -> np.ndarray:
    """Random global gain/gamma on [0, 1] images, one draw per sequence
    (reference: train/scripts/utils/data_utils.py:41-45)."""
    gamma = gamma_range[0] + rng.rand() * (gamma_range[1] - gamma_range[0])
    gain = gain_range[0] + rng.rand() * (gain_range[1] - gain_range[0])
    return np.clip(gain * np.power(image, gamma), 0.0, 1.0)


class EventPackDataset:
    def __init__(
        self,
        mode: str,
        data_dir: str,
        partial_dataset: float = 1,
        seq_len: int = 16,
        frame_size: Tuple[int, int] = (260, 346),
        num_bins: int = 10,
        random_flip: bool = False,
        flip_x_prob: float = 0.5,
        flip_y_prob: float = 0.0,
        seed: int = 2333,
        include_flows: bool = True,
        include_lfr: bool = True,
        illum_aug: bool = False,
    ):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.seq_len = seq_len
        self.frame_size = frame_size
        self.num_bins = num_bins
        self.random_flip = random_flip
        self.flip_x_prob = flip_x_prob
        self.flip_y_prob = flip_y_prob
        self.include_flows = include_flows
        self.include_lfr = include_lfr
        self.illum_aug = illum_aug
        self.data_paths = split_paths(data_dir, seed=seed)[mode]
        self.partial_dataset = partial_dataset
        self._rng = np.random.RandomState(seed + hash(mode) % 1000)

    def __len__(self) -> int:
        return int(self.partial_dataset * len(self.data_paths))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        with open(self.data_paths[idx], "rb") as f:
            packet = pickle.load(f)

        images = packet["images"]                       # (17, H, W) uint8
        # pair-stack + normalize (reference: event_pack_dataset.py:66-75)
        units = np.stack([images[:-1], images[1:]], axis=-1).astype(np.float32)
        units = units / 255.0                           # (16, H, W, 2)
        if self.mode == "train" and self.illum_aug:
            units = apply_illum_augmentation(units, self._rng)
        units = (units - FRAME_MEAN) / FRAME_STD

        h, w = images.shape[1:]   # actual packet geometry
        voxels = np.stack(
            [
                gen_discretized_event_volume_np(ev, (self.num_bins * 2, h, w))
                for ev in packet["events"]
            ],
            axis=0,
        )                                               # (16, 20, H, W)
        voxels = np.moveaxis(voxels, 1, -1)             # (16, H, W, 20)

        imu = np.concatenate(
            [packet["accelerometers"], packet["gyroscopes"]], axis=1
        )[1:].astype(np.float32)                        # (16, 6)

        out: Dict[str, np.ndarray] = {}
        if self.include_flows and "optical_flow" in packet:
            of = (np.moveaxis(packet["optical_flow"], 1, -1).astype(np.float32)
                  - OPTFLOW_MEAN) / OPTFLOW_STD
            af = (np.moveaxis(packet["acc_flow"], 1, -1).astype(np.float32)
                  - ACCFLOW_MEAN) / ACCFLOW_STD
            out["flows"] = np.concatenate([of, af], axis=-1)  # (16, H, W, 4)
        if self.include_lfr:
            lfr = gen_log_frame_residual_batch(images.astype(np.float32))
            out["lfr"] = np.moveaxis(lfr, 1, -1)        # (16, H, W, 1)

        L = self.seq_len
        if 0 < L < 16:
            units, voxels, imu = units[:L], voxels[:L], imu[:L]
            out = {k: v[:L] for k, v in out.items()}

        if self.mode == "train" and self.random_flip:
            units, voxels, imu, out = self._flip(units, voxels, imu, out)

        out.update(image_units=units, voxels=voxels, imu=imu)
        return out

    def _flip(self, units, voxels, imu, extras):
        """Horizontal/vertical flip with IMU sign corrections
        (reference: train/scripts/utils/data_utils.py:10-39)."""
        if self._rng.rand() < self.flip_x_prob:
            units = units[:, :, ::-1].copy()
            voxels = voxels[:, :, ::-1].copy()
            extras = {k: v[:, :, ::-1].copy() for k, v in extras.items()}
            imu = imu.copy()
            imu[:, 0], imu[:, 4], imu[:, 5] = -imu[:, 0], -imu[:, 4], -imu[:, 5]
        if self._rng.rand() < self.flip_y_prob:
            units = units[:, ::-1].copy()
            voxels = voxels[:, ::-1].copy()
            extras = {k: v[:, ::-1].copy() for k, v in extras.items()}
            imu = imu.copy()
            imu[:, 1], imu[:, 3], imu[:, 5] = -imu[:, 1], -imu[:, 3], -imu[:, 5]
        return units, voxels, imu, extras
