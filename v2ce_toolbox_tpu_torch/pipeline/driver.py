"""End-to-end video -> voxels -> events pipeline driver (center mode).

  host:   decode + resize
  device: pair-stack + normalize + V2ce3d forward per window batch, the
          window merge, the event-frame render, and per chunk of
          `stage2_batch_size` frames the LDATI sampler with the stream
          flatten and the bit-packed wire format
  host:   wire decode into the `event_stream` npz, and the preview mp4

Wire format (as in v2ce_toolbox_tpu/pipeline/driver.py): each event is a
(10 + x_bits + delta_bits)-bit record — delta µs to the previous event in
the top bits (all ones = marker: the absolute in-chunk µs rides the side
list, in stream order), x above bit 10, y in bits 1..9, polarity in bit
0 — bit-packed 32 records to b words. Dense streams ship 3-bit deltas;
when markers exceed 9/32 of the events the chunk is re-encoded with the
widest delta that keeps a record in one word.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import os.path as op
import time
from typing import List, Optional

import numpy as np
import torch

from v2ce_toolbox_tpu_torch.config import PipelineConfig, SamplerConfig
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.ops.bitpack import pack_bits, unpack_bits
from v2ce_toolbox_tpu_torch.ops.compact import INVALID, compact_rows, merge_sorted_rows
from v2ce_toolbox_tpu_torch.ops.ldati import Draw, check_config, make_draw, sample_rows
from v2ce_toolbox_tpu_torch.pipeline.infer import make_forward_fn
from v2ce_toolbox_tpu_torch.pipeline.preprocess import resize_frames
from v2ce_toolbox_tpu_torch.pipeline.render import render_event_frames_cmajor
from v2ce_toolbox_tpu_torch.pipeline.windows import plan_windows
from v2ce_toolbox_tpu_torch.utils.weights import load_weights

logger = logging.getLogger(__name__)

DELTA_BITS = 3
# marker fraction above which the 3-bit format's side list outweighs the
# wide format's records: 22n/8 + 4m > 31n/8  <=>  m > 9n/32
_SPARSE_SWITCH = 9 / 32


def _x_bits_for_width(width: int) -> int:
    """x field width: 9 bits up to 512 px wide, else 10."""
    return 9 if width <= 512 else 10


def _sparse_delta_bits(x_bits: int) -> int:
    """Widest delta field keeping the record inside one 32-bit word."""
    return min(12, 32 - (10 + x_bits))


def _side_cap(frames: int, cap: int, span_us: int, delta_bits: int = DELTA_BITS) -> int:
    """Side-list capacity. The stream is time-sorted, so every marker means
    a gap >= the marker value: a chunk spanning span_us holds at most
    span_us / marker of them, plus the first event of each frame."""
    marker = (1 << delta_bits) - 1
    n = min(frames * cap, span_us // marker + frames + 64)
    return -(-n // 2048) * 2048


def _flatten_rows(rel: torch.Tensor, gvox: torch.Tensor, total_emit: torch.Tensor,
                  cap_drop: torch.Tensor, offsets_us: torch.Tensor, *,
                  h: int, w: int, capacity: int, frames: int, fps: int,
                  skip_lead: int = 0, side_cap: int = 1 << 17,
                  delta_bits: int = DELTA_BITS, x_bits: int = 9):
    """The wire format assembled on the sampler's post-sort rows, then one
    merge (K3) into the flat stream (`driver.py:204-314` of the JAX
    package).

    Returns (words (b, N/32) int32 holding uint32 bits, kept, side_key,
    n_side, side_total, dropped (F,)): dropped is the per-frame sampler
    drop accounting, capacity clipping included."""
    rr, wd = rel.shape
    cb = 9
    f = rr // cb
    p = 2
    dev = rel.device
    voxel_step = 1.0 / fps / cb
    valid = rel != INVALID
    row_id = torch.arange(rr, device=dev)
    frame_row = row_id // cb
    bin_row = row_id % cb
    frame = frame_row[:, None]

    # per-frame capacity clipping: the merge keeps the first cap_eff events
    # of each frame's bin-concatenated stream
    cap_eff = min(capacity, -(-cb * wd // 128) * 128)
    if cb * wd > cap_eff:
        cnt_row = valid.sum(dim=1, dtype=torch.int32).view(f, cb)
        prefix = (torch.cumsum(cnt_row, dim=1) - cnt_row).view(rr)
        pos = torch.arange(wd, device=dev)
        valid = valid & (prefix[:, None] + pos[None, :] < cap_eff)

    kept_frame = valid.sum(dim=1, dtype=torch.int32).view(f, cb).sum(dim=1, dtype=torch.int32)
    dropped = total_emit - kept_frame + cap_drop

    # wire-visible events: real frames only, minus the skip_lead overlap
    valid = valid & (frame < frames)
    if skip_lead:
        valid = valid & (frame >= skip_lead)

    # absolute in-chunk µs, with the JAX float expression for bin starts
    bin_start_us = ((bin_row.float() * torch.tensor(np.float32(voxel_step), device=dev))
                    * torch.tensor(np.float32(1e6), device=dev)).to(torch.int64)
    off_row = offsets_us.to(torch.int64)[torch.clamp(frame_row, max=f - 1)]
    t_abs = torch.where(valid, rel.to(torch.int64) + (bin_start_us + off_row)[:, None], 0)
    hw = h * w
    rem = gvox % (p * hw)
    p_idx = rem // hw                       # flipped P: 1 = ON
    yx = rem % hw
    payload = ((yx % w) << 10) | ((yx // w) << 1) | p_idx

    # deltas per row: the valids are a sorted prefix, so prev is a shift;
    # a row's first event needs the last key of the previous non-empty row
    has = valid.any(dim=1)
    last = torch.where(valid, t_abs, -(2 ** 31 - 1)).amax(dim=1)
    nonempty = torch.where(has, row_id, -1)
    src = torch.cummax(nonempty, dim=0).values            # last non-empty row <= r
    inc_val = torch.where(src >= 0, last[torch.clamp(src, min=0)], 0)
    prev_last = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), inc_val[:-1]])
    prev = torch.cat([prev_last[:, None], t_abs[:, :-1]], dim=1)
    delta = t_abs - prev
    marker = (1 << delta_bits) - 1
    pbits = 10 + x_bits
    is_exc = valid & ((delta < 0) | (delta >= marker))
    delta_enc = torch.where(is_exc, marker, torch.clamp(delta, min=0))
    recs_rows = ((delta_enc << pbits) | payload).to(torch.int32)

    flat_cap = rr * wd
    worst_rec = (marker << pbits) | ((w - 1) << 10) | ((h - 1) << 1) | 1
    if 0 <= worst_rec < INVALID:
        # one-word merge: the record is its own key (INVALID marks empty
        # slots; no real record reaches it by the bound above)
        out_recs, _, kept, _ = merge_sorted_rows(
            torch.where(valid, recs_rows, INVALID), (), nb=rr, cap=flat_cap)
    else:
        _, (out_recs,), kept, _ = merge_sorted_rows(
            torch.where(valid, t_abs.to(torch.int32), INVALID),
            [torch.where(valid, recs_rows, 0)], nb=rr, cap=flat_cap)
    words = pack_bits(out_recs[0], pbits + delta_bits)

    # side list: the markers' absolute µs in stream order; a time-sorted
    # row spans one bin, so it holds at most span/marker + 1 markers
    side_chunk = 4096 if wd >= 4096 else wd
    side_cand = torch.where(is_exc, t_abs.to(torch.int32), INVALID)
    side_rows, _, _, ns_tot = compact_rows(side_cand, (), cap=side_chunk, chunk=side_chunk)
    side_cap_eff = min(-(-side_cap // 128) * 128, rr * side_rows.shape[1])
    side_flat, _, n_side, _ = merge_sorted_rows(side_rows, (), nb=rr, cap=side_cap_eff)
    return words, kept[0], side_flat[0], n_side[0], ns_tot.sum(), dropped


def _decode_packed_events(words: np.ndarray, side_key: np.ndarray, n: int,
                          delta_bits: int = DELTA_BITS, x_bits: int = 9):
    """Host-side decode of the wire format: returns (t_us int64, x, y, p).
    `words` must already be sliced to ceil(n/32) columns, side_key to
    n_side."""
    marker = (1 << delta_bits) - 1
    pbits = 10 + x_bits
    recs = unpack_bits(words, pbits + delta_bits, n)
    delta = (recs >> pbits) & marker
    x = ((recs >> 10) & ((1 << x_bits) - 1)).astype(np.int16)
    y = ((recs >> 1) & 0x1FF).astype(np.int16)
    p = (recs & 1).astype(np.int8)
    is_marker = delta == marker
    raw = np.cumsum(np.where(is_marker, 0, delta).astype(np.int64))
    side = np.asarray(side_key).astype(np.int64)
    seg = np.cumsum(is_marker)            # 0 before the first marker
    n_marker = int(seg[-1]) if n else 0
    assert side.shape[0] == n_marker, (side.shape, n_marker)
    base = np.concatenate(
        [np.zeros(1, np.int64), side - raw[np.flatnonzero(is_marker)]])
    ts = raw + base[seg]
    return ts, x, y, p


def _fetch_chunk_events_fused(voxels: torch.Tensor, draw: Draw,
                              offsets_us: torch.Tensor, frames: int,
                              scfg: SamplerConfig, fps: int, skip_lead: int = 0,
                              base_us: int = 0, width: int = 512) -> np.ndarray:
    """Sample one chunk (F, 2, 10, H, W), flatten it to the wire format,
    fetch and decode it to an EVENT_DTYPE array. The dense (3-bit delta)
    encoding is tried first; a stream whose markers exceed 9/32 of its
    events is re-encoded in the sparse format from the same sampled rows
    (the JAX package re-samples with the same draws; the rows are equal)."""
    f, _, _, h, w = voxels.shape
    scfg = dataclasses.replace(scfg, fps=fps)
    rows = sample_rows(voxels, draw, scfg)
    span = int((f + 1) * 1e6 / fps) + 2
    x_bits = _x_bits_for_width(width)
    kw = dict(h=h, w=w, capacity=scfg.event_capacity, frames=frames, fps=fps,
              skip_lead=skip_lead, x_bits=x_bits)
    bits = DELTA_BITS
    scap = _side_cap(f, scfg.event_capacity, span, bits)
    words, kept, side_key, n_side, side_total, _ = _flatten_rows(
        *rows, offsets_us, side_cap=scap, delta_bits=bits, **kw)
    n, m = int(kept), int(n_side)
    assert int(side_total) == m <= scap, (int(side_total), m, scap)
    if m > n * _SPARSE_SWITCH:
        bits = _sparse_delta_bits(x_bits)
        scap = _side_cap(f, scfg.event_capacity, span, bits)
        words, kept, side_key, n_side, side_total, _ = _flatten_rows(
            *rows, offsets_us, side_cap=scap, delta_bits=bits, **kw)
        n, m = int(kept), int(n_side)
        assert int(side_total) == m <= scap, (int(side_total), m, scap)
    ts, x_, y_, p_ = _decode_packed_events(
        words[:, :-(-n // 32)].cpu().numpy(), side_key[:m].cpu().numpy(), n,
        delta_bits=bits, x_bits=x_bits)
    out = np.zeros(n, dtype=EVENT_DTYPE)
    out["timestamp"] = ts + np.int64(base_us)
    out["x"], out["y"], out["polarity"] = x_, y_, p_
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class V2cePipeline:
    """Video/image-sequence -> event stream converter (stage 1 + stage 2)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 model_path: Optional[str] = None, device="cuda", seed: int = 0):
        """device: where the model and the sampler run; seed: the weight
        init (when model_path does not exist) and the sampler draws."""
        if config.infer_type != "center":
            raise NotImplementedError(
                f"infer_type={config.infer_type!r}: only 'center' is ported "
                "(pano is ROADMAP item 9)")
        if config.model.compute_dtype != torch.float32:
            raise NotImplementedError("bf16 inference is not ported yet")
        check_config(dataclasses.replace(config.sampler, fps=config.fps), 2, 10,
                     config.height, config.width)
        self.config = config
        self.device = torch.device(device)
        self.seed = seed
        self.model = V2ce3d(config.model)
        load_weights(self.model, model_path, seed)
        self.model.to(self.device).eval()
        self._fwd = make_forward_fn(self.model, infer_type=config.infer_type,
                                    width=config.width)
        self.timings = {}

    # -- stage 1 ----------------------------------------------------------

    def video_to_voxels(self, *, vidcap=None, image_paths=None) -> torch.Tensor:
        """Run stage 1 over a whole video; returns the merged voxels in
        channel-major layout (T, 20, H, W), T = frame_count - 1."""
        cfg = self.config
        if (vidcap is None) == (image_paths is None):
            raise ValueError("give exactly one of vidcap and image_paths")
        frame_count = vidcap.frame_count if vidcap is not None else len(image_paths)
        starts, mode = plan_windows(frame_count, cfg.seq_len)
        outputs: List[torch.Tensor] = []
        batch: List[np.ndarray] = []

        def flush():
            if batch:
                frames = torch.from_numpy(np.stack(batch, axis=0)).to(self.device)
                out = self._fwd(frames)                     # (b, L, H, W, 20)
                outputs.append(out.permute(0, 1, 4, 2, 3))  # (b, L, 20, H, W)
                batch.clear()

        t0 = time.perf_counter()
        for start in starts:
            idx = range(int(start), int(start) + cfg.seq_len + 1)
            if vidcap is not None:
                raw = vidcap.read_frames_at_indices(idx)
            else:
                from v2ce_toolbox_tpu_torch.io.video import read_gray_images

                raw = read_gray_images([image_paths[i] for i in idx])
            batch.append(resize_frames(raw, cfg.height))
            if len(batch) == cfg.batch_size:
                flush()
        flush()
        voxels = self._merge(torch.cat(outputs, dim=0), mode)
        _sync(self.device)
        self.timings.update(stage1_s=time.perf_counter() - t0, windows=len(starts))
        return voxels

    @staticmethod
    def _merge(windows: torch.Tensor, mode: int) -> torch.Tensor:
        s, seq_len = windows.shape[:2]
        parts = []
        if s > 1:
            parts.append(windows[:-1].reshape((s - 1) * seq_len, *windows.shape[2:]))
        last = windows[-1]
        parts.append(last[-mode:] if mode != 0 else last)
        return torch.cat(parts, dim=0).contiguous()

    # -- stage 2 ----------------------------------------------------------

    def voxels_to_event_stream(self, voxels: torch.Tensor) -> np.ndarray:
        """Merged voxels (T, 20, H, W) -> ONE structured event stream with
        the per-frame i/fps offsets applied. Chunks of stage2_batch_size
        frames are sampled with draws seeded from (seed, chunk index)."""
        cfg = self.config
        t, c, h, w = voxels.shape
        v = voxels.reshape(t, 2, c // 2, h, w)
        chunk = cfg.stage2_batch_size
        if (chunk - 1) / cfg.fps * 1e6 + 2e6 >= 2 ** 31:
            raise ValueError(f"stage2_batch_size={chunk} spans more µs than an "
                             "int32 in-chunk timestamp holds")
        n_chunks = -(-t // chunk)
        pad = n_chunks * chunk - t
        if pad:
            v = torch.cat([v, v.new_zeros((pad, *v.shape[1:]))], dim=0)
        t0 = time.perf_counter()
        parts = []
        for i in range(n_chunks):
            base = i * chunk
            frames = min(chunk, t - base)
            offsets64 = ((np.arange(chunk) + base) / cfg.fps * 1e6).astype(np.int64)
            base_us = int(offsets64[0])
            rel = offsets64 - base_us           # in-chunk: spans chunk/fps s
            rel_t = torch.from_numpy(rel.astype(np.int32)).to(v.device)
            parts.append(_fetch_chunk_events_fused(
                v[base:base + chunk].contiguous(),
                make_draw(self.seed, i, v.device), rel_t, frames,
                cfg.sampler, cfg.fps, base_us=base_us, width=w))
        self.timings.update(stage2_s=time.perf_counter() - t0, chunks=n_chunks)
        return np.concatenate(parts) if parts else np.zeros(0, EVENT_DTYPE)

    # -- full run ---------------------------------------------------------

    def run(self, *, input_video_path: Optional[str] = None,
            image_folder: Optional[str] = None, out_folder: str = "./output",
            out_name_suffix: str = "") -> dict:
        """Full CLI run; returns paths, counts and timings."""
        from v2ce_toolbox_tpu_torch.io.video import (
            VideoReader,
            list_image_frames,
            write_video,
        )

        cfg = self.config
        if (input_video_path is None) == (image_folder is None):
            raise ValueError("give exactly one of input_video_path and image_folder")
        os.makedirs(out_folder, exist_ok=True)
        if image_folder is not None:
            name = op.basename(op.normpath(image_folder))
        else:
            name = op.splitext(op.basename(input_video_path))[0]
        output_name = f"{name}-ceil_{cfg.ceil}-fps_{cfg.fps}"
        if out_name_suffix:
            output_name += f"-{out_name_suffix}"

        self.timings = {}
        t_start = time.time()
        if image_folder is not None:
            paths = list_image_frames(image_folder, cfg.max_frame_num)
            voxels = self.video_to_voxels(image_paths=paths)
            n_frames = len(paths)
        else:
            vidcap = VideoReader(input_video_path, color_mode="GRAY")
            if cfg.max_frame_num and vidcap.frame_count > cfg.max_frame_num:
                vidcap.frame_count = cfg.max_frame_num
            voxels = self.video_to_voxels(vidcap=vidcap)
            n_frames = vidcap.frame_count
            vidcap.close()

        t_, c_, h_, w_ = voxels.shape
        result = {"voxels_shape": (t_, h_, w_, c_)}   # logical, channels-last
        if cfg.write_event_frame_video:
            frames = render_event_frames_cmajor(
                voxels, ceil=float(cfg.ceil),
                upper_bound_percentile=cfg.upper_bound_percentile,
                keep_polarity=cfg.vis_keep_polarity)
            vis_color = "rgb" if cfg.vis_keep_polarity else "gray"
            ef_path = op.join(out_folder,
                              f"{cfg.infer_type}-{output_name}-pred_ef_{vis_color}.mp4")
            write_video(frames, ef_path, cfg.fps)
            result["event_frame_video"] = ef_path

        event_stream = self.voxels_to_event_stream(voxels)
        ev_path = op.join(out_folder, f"{output_name}-events.npz")
        np.savez(ev_path, event_stream=event_stream)
        result.update(event_stream_path=ev_path, num_events=int(event_stream.shape[0]),
                      num_frames=n_frames, wall_time_s=time.time() - t_start,
                      timings=dict(self.timings))
        logger.info("%d frames -> %d events in %.2fs", n_frames,
                    result["num_events"], result["wall_time_s"])
        return result
