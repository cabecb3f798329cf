"""MVSEC HDF5 -> 16-frame training packets.

Re-design of the reference's MVSEC converter
(reference: train/scripts/tools/MVSEC_data_utils.py:70-247): reads the
`davis/<left|right>/` groups (image_raw, image_raw_ts, image_raw_event_inds,
events, imu), pairs events to [frame_t, frame_{t+1}) intervals using the
per-frame event indices, and dumps pkl packets with the schema consumed by
EventPackDataset.

The reference additionally attaches FastFlowNet optical flow per packet
(its CUDA correlation op is the repo's only native dependency,
train/scripts/utils/fastflownet.py:5). Here the flow backend is a
`pair_flow_fn(images_a, images_b) -> (N, 2, H, W)` callable:
`fastflownet_pair_flow()` runs the port's FastFlowNet on the card (its
cost volume is the K8 CUDA kernel; pass the state_dict of a converted
checkpoint for reference-matching flow), `farneback_flow` is a cv2 host
fallback. `optical_flow` is frame_t -> frame_{t+1}; `acc_flow[i]` is
flow(i -> i+1) + flow(i -> i-1), the reference's forward+backward sum
(MVSEC_data_utils.py:165-179).

Also here: the reference's HDR / linearize helpers and exporters
(events -> E2VID txt, frames -> HDRnet input folder;
MVSEC_data_utils.py:398-453, 455-492).

The port of `v2ce_toolbox_tpu/data/mvsec.py`: the same packets, with the
h5py read split from the packet build (`convert_mvsec_arrays`), and
`--fastflownet_ckpt` taking the port's torch `.pt` state_dict (the JAX
package's flag takes an orbax checkpoint).

    python -m v2ce_toolbox_tpu_torch.data.mvsec -i outdoor_day1_data.hdf5 \
        -o packets/ --fastflownet_ckpt fastflownet.pt
"""

from __future__ import annotations

import os
import os.path as op
import pickle
from typing import Callable, Optional

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.models.fastflownet import OpticalFlowCalculator


def _to_structured(ev_slice: np.ndarray, t_scale: float = 1e6) -> np.ndarray:
    """MVSEC raw events rows are [x, y, t(s), p(+1/-1)]
    (reference: MVSEC_data_utils.py:143-146)."""
    out = np.zeros(len(ev_slice), dtype=EVENT_DTYPE)
    out["x"] = ev_slice[:, 0].astype(np.int16)
    out["y"] = ev_slice[:, 1].astype(np.int16)
    out["timestamp"] = (ev_slice[:, 2] * t_scale).astype(np.int64)
    out["polarity"] = (ev_slice[:, 3] > 0).astype(np.int8)
    return out


def convert_mvsec_arrays(
    images: np.ndarray,
    image_ts: np.ndarray,
    event_inds: np.ndarray,
    events: np.ndarray,
    imu: np.ndarray,
    imu_ts: np.ndarray,
    out_dir: str,
    prefix: str,
    frames_per_sequence: int = 16,
    max_sequences: Optional[int] = None,
    pair_flow_fn: Optional[Callable] = None,
) -> int:
    """Cut one recording's arrays into packets `<prefix>_<s:05d>.pkl` in
    out_dir; returns the number of packets written.

    Args:
      images: (N, H, W) uint8 frames; image_ts: (N,) seconds.
      event_inds: (N,) index of each frame's first event in `events`.
      events: (M, 4) rows [x, y, t(s), p(+1/-1)].
      imu: (K, 6) [acc, gyro] rows at imu_ts (K,) seconds; K may be 0.
    """
    os.makedirs(out_dir, exist_ok=True)
    event_inds = np.asarray(event_inds).astype(np.int64)
    n_frames = len(images)
    fpp = frames_per_sequence + 1                      # 17 images per packet
    n_packets = (n_frames - 1) // frames_per_sequence
    if max_sequences:
        n_packets = min(n_packets, max_sequences)

    written = 0
    for s in range(n_packets):
        lo = s * frames_per_sequence
        hi = lo + fpp
        if hi > n_frames:
            break
        pkt_images = images[lo:hi]
        pkt_ts = (image_ts[lo:hi] * 1e6).astype(np.int64)

        # per-interval events via the frame->event index map
        # (reference pairs events to frame intervals with leftover carry,
        # MVSEC_data_utils.py:160-210; the index map gives the same cut)
        pkt_events = []
        for i in range(lo, lo + frames_per_sequence):
            a = event_inds[i]
            b = event_inds[i + 1]
            pkt_events.append(_to_structured(events[max(a, 0):max(b, 0)]))

        # nearest-IMU alignment per frame timestamp
        if len(imu_ts):
            idx = np.searchsorted(imu_ts, image_ts[lo:hi])
            idx = np.clip(idx, 0, len(imu) - 1)
            acc = imu[idx][:, 0:3]
            gyro = imu[idx][:, 3:6]
        else:
            acc = np.zeros((fpp, 3))
            gyro = np.zeros((fpp, 3))

        packet = {
            "images": pkt_images,
            "events": pkt_events,
            "accelerometers": acc,
            "gyroscopes": gyro,
            "timestamps": pkt_ts,
        }
        if pair_flow_fn is not None:
            # forward flow for the 16 intervals (MVSEC_data_utils.py:297)
            fwd = pair_flow_fn(pkt_images[:-1], pkt_images[1:])
            packet["optical_flow"] = fwd
            # acceleration flow: flow(i->i+1) + flow(i->i-1) per frame
            # (MVSEC_data_utils.py:165-179); the file's first frame has no
            # predecessor -> its backward term is zero.
            if lo == 0:
                bwd_tail = pair_flow_fn(pkt_images[1:-1], pkt_images[:-2])
                bwd = np.concatenate(
                    [np.zeros_like(bwd_tail[:1]), bwd_tail], axis=0)
            else:
                bwd = pair_flow_fn(pkt_images[:-1], images[lo - 1:hi - 2])
            packet["acc_flow"] = fwd + bwd
        out_path = op.join(out_dir, f"{prefix}_{s:05d}.pkl")
        with open(out_path, "wb") as fo:
            pickle.dump(packet, fo)
        written += 1
    return written


def convert_mvsec_h5(
    path: str,
    out_dir: str,
    which: str = "left",
    frames_per_sequence: int = 16,
    max_sequences: Optional[int] = None,
    pair_flow_fn: Optional[Callable] = None,
) -> int:
    """Convert one MVSEC *_data.hdf5 file into packets; returns the number
    of packets written."""
    import h5py

    if which not in ("left", "right"):
        raise ValueError(f"which must be 'left' or 'right', got {which!r}")
    prefix = op.basename(path).split(".")[0] + "_" + which
    with h5py.File(path, "r") as f:
        g = f["davis"][which]
        images = np.array(g["image_raw"])              # (N, H, W) uint8
        image_ts = np.array(g["image_raw_ts"])         # (N,) seconds
        event_inds = np.array(g["image_raw_event_inds"])
        events = np.array(g["events"])                 # (M, 4)
        imu = np.array(g["imu"]) if "imu" in g else np.zeros((0, 6))
        imu_ts = (np.array(g["imu_ts"]) if "imu_ts" in g
                  else np.zeros((0,)))
    return convert_mvsec_arrays(images, image_ts, event_inds, events, imu, imu_ts,
                                out_dir, prefix, frames_per_sequence, max_sequences,
                                pair_flow_fn)


def farneback_flow(images_a: np.ndarray, images_b: np.ndarray) -> np.ndarray:
    """cv2 Farneback pair flow: a host-side stand-in for FastFlowNet
    (whose weights are not shipped in the mirror).
    (N, H, W) uint8 pairs -> (N, 2, H, W) float32."""
    import cv2

    flows = []
    for a, b in zip(images_a, images_b):
        flow = cv2.calcOpticalFlowFarneback(
            a, b, None,
            pyr_scale=0.5, levels=3, winsize=15, iterations=3,
            poly_n=5, poly_sigma=1.2, flags=0)
        flows.append(np.moveaxis(flow, -1, 0))
    return np.stack(flows).astype(np.float32)


def fastflownet_pair_flow(state_dict=None, seed: int = 0, device="cuda",
                          div_flow: float = 20.0, div_size: int = 64) -> Callable:
    """Pair-flow backend running the port's FastFlowNet on `device` — the
    reference converter's OpticalFlowCalculator (MVSEC_data_utils.py:86,
    297; train/scripts/utils/optical_flow.py:20-116). Pass the state_dict
    of a checkpoint converted from `fastflownet_ft_mix.pth` for
    reference-matching flow; without one the weights are random from
    `seed`, which still runs the whole path (shapes, dtypes, kernels)."""
    ofc = OpticalFlowCalculator(state_dict=state_dict, div_flow=div_flow,
                                div_size=div_size, seed=seed, device=device)

    def pair_flow(images_a: np.ndarray, images_b: np.ndarray) -> np.ndarray:
        # gray uint8 -> float [0,1], repeated to 3 channels
        # (MVSEC_data_utils.py:165-168, 292-297)
        def prep(x):
            x = np.asarray(x).astype(np.float32) / 255.0
            return torch.from_numpy(np.repeat(x[:, None], 3, axis=1))

        flow = ofc(prep(images_a), prep(images_b))     # (N, 2, H, W)
        return flow.cpu().numpy()

    return pair_flow


# ---------------------------------------------------------------------------
# HDR / linearize helpers (reference: MVSEC_data_utils.py:455-492 — the
# LiteHDRNet itself is not vendored in the reference either; the
# reproducible parts are the pre/post processing and the linearization)
# ---------------------------------------------------------------------------

def linearize_image(image: np.ndarray, gamma: float = 0.45) -> np.ndarray:
    """Invert the display gamma: x^(1/0.45), after max-normalization
    (reference: MVSEC_data_utils.py:487-490)."""
    image = image.astype(np.float32)
    peak = image.max()
    if peak > 0:
        image = image / peak
    return image ** (1.0 / gamma)


def gray_to_hdr_input(image: np.ndarray) -> np.ndarray:
    """Gray (H, W) -> the HDR net's 2x-resized 3-channel float input
    (reference: MVSEC_data_utils.py:458-466)."""
    import cv2

    x = np.repeat(image.astype(np.float32)[..., None], 3, axis=-1)
    return cv2.resize(x, (x.shape[1] * 2, x.shape[0] * 2))


def raw_to_hdrnet_input(h5_path: str, out_dir: str,
                        which: str = "left") -> int:
    """Dump every raw frame as a 3-channel jpg plus the Exposures.txt /
    img_list.txt manifests HDRnet expects
    (reference: MVSEC_data_utils.py:423-453). Returns the frame count."""
    import h5py
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    with open(op.join(out_dir, "Exposures.txt"), "w") as f:
        f.write("-3\n0\n3\n")
    n = 0
    with h5py.File(h5_path, "r") as data_file, \
            open(op.join(out_dir, "img_list.txt"), "w") as manifest:
        g = data_file["davis"][which]
        inds = np.array(g["image_raw_event_inds"])
        for idx, image in enumerate(g["image_raw"]):
            img = np.clip(image.astype(np.float32), 0, 255).astype(np.uint8)
            img = np.repeat(img[..., None], 3, axis=-1)
            cv2.imwrite(op.join(out_dir, f"{inds[idx]}.jpg"), img)
            manifest.write(f"{inds[idx]}.png\n")
            n += 1
    return n


def events_to_txt(h5_path: str, out_dir: str, which: str = "left") -> str:
    """Export the raw event stream as the E2VID text format: a '346 260'
    header then 't x y p' lines (reference: MVSEC_data_utils.py:398-418).
    Streams in chunks instead of materializing a python list per event.
    Returns the written file path."""
    import h5py

    name = op.splitext(op.basename(h5_path))[0] + "_" + which
    os.makedirs(out_dir, exist_ok=True)
    out_path = op.join(out_dir, name + ".txt")
    with open(out_path, "w") as f, h5py.File(h5_path, "r") as data_file:
        ev = data_file["davis"][which]["events"]
        f.write("346 260\n")
        chunk = 1 << 20
        for lo in range(0, len(ev), chunk):
            block = np.asarray(ev[lo:lo + chunk])
            for t, x, y, p in zip(block[:, 2], block[:, 0].astype(int),
                                  block[:, 1].astype(int),
                                  block[:, 3].astype(int)):
                f.write(f"{t} {x} {y} {p}\n")
    return out_path


def main(argv=None) -> int:
    """The converter's command line; returns the number of packets
    written."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--h5_path", required=True)
    ap.add_argument("-o", "--out_dir", required=True)
    ap.add_argument("--which", default="left", choices=["left", "right"])
    ap.add_argument("--frames_per_sequence", type=int, default=16)
    ap.add_argument("--max_sequences", type=int, default=None)
    ap.add_argument("--with_flow", action="store_true",
                    help="attach Farneback optical_flow/acc_flow fields")
    ap.add_argument("--fastflownet_ckpt", default=None,
                    help="the port's FastFlowNet state_dict (.pt); implies "
                         "flow fields via the torch net")
    ap.add_argument("--device", default="cuda",
                    help="device of the FastFlowNet flow (default cuda)")
    args = ap.parse_args(argv)
    flow = None
    if args.fastflownet_ckpt:
        from v2ce_toolbox_tpu_torch.utils.weights import load_fastflownet

        flow = fastflownet_pair_flow(load_fastflownet(args.fastflownet_ckpt),
                                     device=args.device)
    elif args.with_flow:
        flow = farneback_flow
    n = convert_mvsec_h5(args.h5_path, args.out_dir, args.which,
                         args.frames_per_sequence, args.max_sequences,
                         flow)
    print(f"wrote {n} packets to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
