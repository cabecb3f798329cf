"""End-to-end video -> voxels -> events pipeline driver.

  host:   decode + resize
  device: pair-stack + normalize + V2ce3d forward per window batch (center
          crop, or pano strips folded into the batch axis), the window
          merge, the event-frame render, and per chunk of
          `stage2_batch_size` frames the LDATI sampler with the stream
          flatten and the bit-packed wire format
  host:   wire decode into the `event_stream` npz, and the preview mp4

`run` holds the whole clip's voxels; `run_streaming` runs the same steps
per 16-frame window and keeps only the per-polarity sums for the preview.

With a data-parallel mesh (`parallel/mesh.py`; the JAX `V2cePipeline`'s `mesh=`)
the ranks share the work, and the event stream and the preview are
byte-identical to one device's: window or chunk i draws from
`make_draw(seed, i)` whichever rank runs it, and a stage-1 batch runs on
one rank as a whole. `run_streaming` round-robins the windows over the
ranks; `run` round-robins stage 1's window batches, gathers the windows on
every rank, and round-robins stage 2's chunks. Rank 0 gathers the records
in order and alone writes the files.
Stage 2 takes the fused route (the sampler's post-sort rows straight into
the wire format, `_fetch_chunk_events_fused`) unless the configuration
needs the EventStream route (bidirectional relocation, or a geometry whose
voxel ids the packed key cannot hold, which runs the v2 sampler core):
`sample_events` -> per-frame buffers -> `_flatten_chunk_stream` (K5).

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
from v2ce_toolbox_tpu_torch.events import EVENT_DTYPE, EventStream, to_recarrays
from v2ce_toolbox_tpu_torch.models import V2ce3d
from v2ce_toolbox_tpu_torch.ops.bitpack import pack_bits, unpack_bits
from v2ce_toolbox_tpu_torch.ops.compact import (
    INVALID,
    append_rows,
    compact_rows,
    merge_sorted_rows,
)
from v2ce_toolbox_tpu_torch.ops.ldati import (
    Draw,
    check_config,
    make_draw,
    sample_events,
    sample_rows,
    supports_rows,
)
from v2ce_toolbox_tpu_torch.parallel.mesh import all_gather_rows, gather_to_lead
from v2ce_toolbox_tpu_torch.pipeline.infer import make_forward_fn
from v2ce_toolbox_tpu_torch.pipeline.preprocess import resize_frames
from v2ce_toolbox_tpu_torch.pipeline.render import (
    render_event_frames_cmajor,
    render_event_frames_from_sums,
)
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


def check_wire(height: int, width: Optional[int] = None) -> None:
    """Raise unless every (y, x) of a height x width stream fits the wire
    record: y has 9 bits and x 10 at most (`_x_bits_for_width`). Past them
    y runs into x's field and x into the delta's, and the JAX package
    writes wrong coordinates and timestamps without an error. With width
    None only the height is checked (a pano stream's width is known at its
    first window)."""
    if height > 512 or (width is not None and width > 1024):
        raise ValueError(
            f"a {height}x{width or '?'} event stream does not fit the wire record: y has "
            "9 bits (height <= 512) and x 10 (width <= 1024)")


def _sparse_delta_bits(x_bits: int) -> int:
    """Widest delta field keeping the record inside one 32-bit word."""
    return min(12, 32 - (10 + x_bits))


def _side_cap(frames: int, cap: int, span_us: int, delta_bits: int = DELTA_BITS,
              monotone: bool = True) -> int:
    """Side-list capacity. A time-sorted stream's every marker means a gap
    >= the marker value: a chunk spanning span_us holds at most span_us /
    marker of them, plus the first event of each frame. 'random' streams
    are not time-sorted (per-bin sorts of raw U[0, 1) s offsets), so any
    event can be a marker: the bound is the event count."""
    marker = (1 << delta_bits) - 1
    bound = span_us // marker + frames + 64 if monotone else frames * cap
    n = min(frames * cap, bound)
    return -(-n // 2048) * 2048


def _wire_rows(rel: torch.Tensor, gvox: torch.Tensor, total_emit: torch.Tensor,
               cap_drop: torch.Tensor, offsets_us: torch.Tensor, *,
               h: int, w: int, capacity: int, frames: int, fps: int,
               skip_lead: int = 0, delta_bits: int = DELTA_BITS, x_bits: int = 9):
    """The wire prep of `_flatten_rows`, elementwise on the sampler's
    post-sort rows: the per-frame capacity clip, each event's absolute
    in-chunk µs, payload, delta and record, and the side-list candidates.

    Returns (valid, t_abs (int64), recs_rows (int32), side_cand (int32,
    INVALID where the record is no marker), dropped (F,))."""
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
    side_cand = torch.where(is_exc, t_abs.to(torch.int32), INVALID)
    return valid, t_abs, recs_rows, side_cand, dropped


def _merge_wire(valid: torch.Tensor, t_abs: torch.Tensor, recs_rows: torch.Tensor, *,
                h: int, w: int, delta_bits: int = DELTA_BITS, x_bits: int = 9):
    """The records' one merge (K3) into the flat stream, bit-packed:
    returns (words (b, N/32) int32 holding uint32 bits, kept)."""
    rr, wd = recs_rows.shape
    marker = (1 << delta_bits) - 1
    pbits = 10 + x_bits
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
    return pack_bits(out_recs[0], pbits + delta_bits), kept[0]


def _flatten_rows(rel: torch.Tensor, gvox: torch.Tensor, total_emit: torch.Tensor,
                  cap_drop: torch.Tensor, offsets_us: torch.Tensor, *,
                  h: int, w: int, capacity: int, frames: int, fps: int,
                  skip_lead: int = 0, side_cap: int = 1 << 17,
                  delta_bits: int = DELTA_BITS, x_bits: int = 9, monotone: bool = True):
    """The wire format assembled on the sampler's post-sort rows
    (`_wire_rows`), then one merge (K3) into the flat stream (`_merge_wire`)
    and the side list (`driver.py:204-314` of the JAX package).

    Returns (words (b, N/32) int32 holding uint32 bits, kept, side_key,
    n_side, side_total, dropped (F,)): dropped is the per-frame sampler
    drop accounting, capacity clipping included."""
    valid, t_abs, recs_rows, side_cand, dropped = _wire_rows(
        rel, gvox, total_emit, cap_drop, offsets_us, h=h, w=w, capacity=capacity,
        frames=frames, fps=fps, skip_lead=skip_lead, delta_bits=delta_bits, x_bits=x_bits)
    words, kept = _merge_wire(valid, t_abs, recs_rows, h=h, w=w, delta_bits=delta_bits,
                              x_bits=x_bits)

    # side list: the markers' absolute µs in stream order; a time-sorted
    # row spans one bin, so it holds at most span/marker + 1 markers, while
    # a 'random' row can be all markers
    rr, wd = side_cand.shape
    if monotone:
        side_chunk = side_row_cap = 4096 if wd >= 4096 else wd
    else:
        side_chunk, side_row_cap = min(4096, wd), wd
    side_rows, _, _, ns_tot = compact_rows(side_cand, (), cap=side_row_cap,
                                           chunk=side_chunk, algo="place")
    side_cap_eff = min(-(-side_cap // 128) * 128, rr * side_rows.shape[1])
    side_flat, _, n_side, _ = merge_sorted_rows(side_rows, (), nb=rr, cap=side_cap_eff)
    return words, kept, side_flat[0], n_side[0], ns_tot.sum(), dropped


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


def _to_records(words: torch.Tensor, side_key: torch.Tensor, n: int, m: int, bits: int,
                x_bits: int, base_us: int) -> np.ndarray:
    """Fetch the kept prefix of the wire words and side list, decode it to
    an EVENT_DTYPE array and add the chunk's int64 start."""
    ts, x_, y_, p_ = _decode_packed_events(
        words[:, :-(-n // 32)].cpu().numpy(), side_key[:m].cpu().numpy(), n,
        delta_bits=bits, x_bits=x_bits)
    out = np.zeros(n, dtype=EVENT_DTYPE)
    out["timestamp"] = ts + np.int64(base_us)
    out["x"], out["y"], out["polarity"] = x_, y_, p_
    return out


def _encode_adaptive(flatten, frames: int, cap: int, span_us: int, x_bits: int,
                     monotone: bool, base_us: int) -> np.ndarray:
    """The dense (3-bit delta) wire encoding first; a stream whose markers
    exceed 9/32 of its events is re-encoded with the widest delta.
    `flatten(delta_bits, side_cap)` returns (words, kept, side_key, n_side,
    side_total); the kept prefix is fetched and decoded to EVENT_DTYPE."""
    for bits in (DELTA_BITS, _sparse_delta_bits(x_bits)):
        scap = _side_cap(frames, cap, span_us, bits, monotone)
        words, kept, side_key, n_side, side_total = flatten(bits, scap)
        n, m = int(kept), int(n_side)
        assert int(side_total) == m <= scap, (int(side_total), m, scap)
        if m <= n * _SPARSE_SWITCH:
            break
    return _to_records(words, side_key, n, m, bits, x_bits, base_us)


def _fetch_chunk_events_fused(voxels: torch.Tensor, draw: Draw,
                              offsets_us: torch.Tensor, frames: int,
                              scfg: SamplerConfig, fps: int, skip_lead: int = 0,
                              base_us: int = 0, width: int = 512) -> np.ndarray:
    """Sample one chunk (F, 2, 10, H, W), flatten it to the wire format,
    fetch and decode it to an EVENT_DTYPE array. A sparse re-encode starts
    from the same sampled rows (the JAX package re-samples with the same
    draws; the rows are equal)."""
    f, _, _, h, w = voxels.shape
    scfg = dataclasses.replace(scfg, fps=fps)
    rows = sample_rows(voxels, draw, scfg)
    monotone = scfg.additional_events_strategy != "random"
    x_bits = _x_bits_for_width(width)

    def flatten(bits, side_cap):
        return _flatten_rows(*rows, offsets_us, h=h, w=w, capacity=scfg.event_capacity,
                             frames=frames, fps=fps, skip_lead=skip_lead,
                             side_cap=side_cap, delta_bits=bits, x_bits=x_bits,
                             monotone=monotone)[:5]

    return _encode_adaptive(flatten, f, scfg.event_capacity, int((f + 1) * 1e6 / fps) + 2,
                            x_bits, monotone, base_us)


def _flatten_chunk_stream(s: EventStream, offsets_us: torch.Tensor, frames: int,
                          skip_lead: int = 0, side_cap: int = 1 << 17,
                          delta_bits: int = DELTA_BITS, x_bits: int = 9):
    """Device-side flatten of a chunk's per-frame event buffers into one
    valid-prefix bit-packed stream (`driver.py:101-157` of the JAX
    package): the buffers are appended (K5), the deltas taken on the flat
    stream, and the markers' absolute µs compacted (K2) into the side list.
    `skip_lead` drops the first frames.

    Returns (words (10 + x_bits + delta_bits, N/32) int32 holding uint32
    bits, kept, side_key, n_side, side_total)."""
    t_us = s.t_us[:frames]
    cap = t_us.shape[1]
    dev = t_us.device
    slot = torch.arange(cap, device=dev)[None, :]
    valid = slot < s.count[:frames, None]
    if skip_lead:
        valid = valid & (torch.arange(frames, device=dev)[:, None] >= skip_lead)
    keys = torch.where(valid, t_us + offsets_us[:frames, None], INVALID)
    pbits = 10 + x_bits
    payload = torch.where(
        valid, (s.x[:frames].to(torch.int32) << 10) | (s.y[:frames].to(torch.int32) << 1)
        | s.p[:frames].to(torch.int32), 0)
    # each frame row is a valid prefix (slot < count): an append, not a
    # compaction
    out_k, (out_p,), kept, _ = append_rows(keys, [payload], cap=frames * cap,
                                           chunk=min(8192, -(-cap // 128) * 128))
    out_k, out_p = out_k[0], out_p[0]

    marker = (1 << delta_bits) - 1
    idx = torch.arange(out_k.shape[0], dtype=torch.int32, device=dev)
    in_prefix = idx < kept
    prev = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), out_k[:-1]])
    delta = out_k - prev                      # first event: its absolute key
    is_exc = in_prefix & ((delta < 0) | (delta >= marker))
    delta_enc = torch.where(is_exc, marker, torch.clamp(delta, min=0))
    recs = torch.where(in_prefix, (delta_enc << pbits) | out_p, 0)
    words = pack_bits(recs, pbits + delta_bits)

    side_in = torch.where(is_exc, idx, INVALID)
    _, (side_key,), n_side, side_total = compact_rows(
        side_in[None], [out_k[None]], cap=side_cap, chunk=8192, algo="place")
    return words, kept[0], side_key[0], n_side[0], side_total[0]


def _fetch_chunk_events(s: EventStream, offsets_us: torch.Tensor, frames: int,
                        fps: float, skip_lead: int = 0, base_us: int = 0,
                        width: int = 512, monotone: bool = True) -> np.ndarray:
    """Flatten + fetch + decode one chunk's EventStream, with the same
    adaptive dense/sparse wire format as the fused route. `offsets_us` are
    chunk-local int32 frame starts; `base_us` is the chunk's int64 start,
    added on the host after the decode."""
    x_bits = _x_bits_for_width(width)

    def flatten(bits, side_cap):
        return _flatten_chunk_stream(s, offsets_us, frames, skip_lead=skip_lead,
                                     side_cap=side_cap, delta_bits=bits, x_bits=x_bits)

    return _encode_adaptive(flatten, frames, int(s.t_us.shape[1]),
                            int((frames + 1) * 1e6 / fps) + 2, x_bits, monotone, base_us)


def _fused_flatten_ok(scfg: SamplerConfig, p: int, h: int, w: int, fps: int) -> bool:
    """Gate of the fused sampler + flatten route (`driver.py:356` of the
    JAX package); the EventStream route takes the rest."""
    return (not scfg.bidirectional
            and supports_rows(p, h, w, fps=fps,
                              additional_events_strategy=scfg.additional_events_strategy,
                              pooling_type=scfg.pooling_type))


def chunk_events(voxels: torch.Tensor, draw: Draw, offsets_us: torch.Tensor,
                 frames: int, scfg: SamplerConfig, fps: int, skip_lead: int = 0,
                 base_us: int = 0) -> np.ndarray:
    """Stage 2 of one chunk (F, 2, 10, H, W) -> EVENT_DTYPE records, through
    the fused route where `_fused_flatten_ok`, else the EventStream route."""
    f, p, _, h, w = voxels.shape
    if _fused_flatten_ok(scfg, p, h, w, fps):
        return _fetch_chunk_events_fused(voxels, draw, offsets_us, frames, scfg, fps,
                                         skip_lead=skip_lead, base_us=base_us, width=w)
    s = sample_events(voxels, draw, dataclasses.replace(scfg, fps=fps))
    return _fetch_chunk_events(s, offsets_us, frames, fps, skip_lead=skip_lead,
                               base_us=base_us, width=w,
                               monotone=scfg.additional_events_strategy != "random")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _output_name(cfg: PipelineConfig, input_video_path: Optional[str],
                 image_folder: Optional[str], out_name_suffix: str) -> str:
    if image_folder is not None:
        name = op.basename(op.normpath(image_folder))
    else:
        name = op.splitext(op.basename(input_video_path))[0]
    output_name = f"{name}-ceil_{cfg.ceil}-fps_{cfg.fps}"
    return f"{output_name}-{out_name_suffix}" if out_name_suffix else output_name


class V2cePipeline:
    """Video/image-sequence -> event stream converter (stage 1 + stage 2)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 model_path: Optional[str] = None, device="cuda", seed: int = 0,
                 mesh=None):
        """device: where the model and the sampler run; seed: the weight
        init (when model_path does not exist) and the sampler draws; mesh:
        a data-parallel `parallel.mesh.DataMesh` to share the work with (its
        device replaces `device`)."""
        if config.infer_type not in ("center", "pano"):
            raise ValueError(f"invalid infer_type {config.infer_type!r}")
        if config.model.out_layout != "cl":
            # the window merge, the sampler's channel-major reshape and the
            # renders take the channels-last prediction
            raise ValueError(
                "V2cePipeline requires ModelConfig.out_layout='cl'; "
                f"got {config.model.out_layout!r} (probe-only option)")
        self.config = config
        if config.infer_type == "center":
            self._check_sampler(config.width)
        else:                           # the pano width is known at the first window
            check_wire(config.height)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.seed = seed
        self.model = V2ce3d(config.model)
        load_weights(self.model, model_path, seed)
        self.model.to(self.device).eval()
        self._fwd_cache = {}
        self.timings = {}

    def _check_sampler(self, out_width: int) -> None:
        """The sampler's settings and the wire record's limits, for a stream
        out_width wide (center: the crop; pano: the resized width)."""
        cfg = self.config
        check_wire(cfg.height, out_width)
        check_config(dataclasses.replace(cfg.sampler, fps=cfg.fps), 2, 10,
                     cfg.height, out_width)

    # -- stage 1 ----------------------------------------------------------

    def _forward_fn(self, resized_width: int):
        """The forward step for frames of width resized_width (pano: one per
        width, checked against the sampler before the first window)."""
        if resized_width not in self._fwd_cache:
            cfg = self.config
            if cfg.infer_type == "pano":
                self._check_sampler(resized_width)
            self._fwd_cache[resized_width] = make_forward_fn(
                self.model, infer_type=cfg.infer_type, width=cfg.width,
                resized_width=resized_width)
        return self._fwd_cache[resized_width]

    def _read_window(self, start: int, vidcap=None, image_paths=None) -> np.ndarray:
        idx = range(int(start), int(start) + self.config.seq_len + 1)
        if vidcap is not None:
            raw = vidcap.read_frames_at_indices(idx)
        else:
            from v2ce_toolbox_tpu_torch.io.video import read_gray_images

            raw = read_gray_images([image_paths[i] for i in idx])
        return resize_frames(raw, self.config.height)

    def _forward(self, frames: np.ndarray) -> torch.Tensor:
        """(b, L+1, H, W') resized frames -> (b, L, 20, H, W_out) voxels."""
        out = self._forward_fn(frames.shape[-1])(
            torch.from_numpy(frames).to(self.device))      # (b, L, H, W_out, 20)
        return out.permute(0, 1, 4, 2, 3)

    def _ranks(self):
        """(this rank, the rank count): (0, 1) without a mesh."""
        return (0, 1) if self.mesh is None else (self.mesh.rank, self.mesh.size)

    def video_to_voxels(self, *, vidcap=None, image_paths=None) -> torch.Tensor:
        """Run stage 1 over a whole video; returns the merged voxels in
        channel-major layout (T, 20, H, W_out), T = frame_count - 1. Under a
        mesh, batch j of `batch_size` windows runs on rank j mod n, and every
        rank gets every window, bit for bit."""
        cfg = self.config
        if (vidcap is None) == (image_paths is None):
            raise ValueError("give exactly one of vidcap and image_paths")
        frame_count = vidcap.frame_count if vidcap is not None else len(image_paths)
        starts, mode = plan_windows(frame_count, cfg.seq_len)
        rank, size = self._ranks()
        groups = [range(g, min(g + cfg.batch_size, len(starts)))
                  for g in range(0, len(starts), cfg.batch_size)]

        t0 = time.perf_counter()
        outputs = [self._forward(np.stack([self._read_window(starts[i], vidcap, image_paths)
                                           for i in group], axis=0))
                   for group in groups[rank::size]]
        windows = torch.cat(outputs, dim=0) if outputs else None
        if self.mesh is not None:
            # rank r holds the windows of groups r, r + n, ...: back to window order
            order = [i for r in range(size) for group in groups[r::size] for i in group]
            gathered = torch.cat(all_gather_rows(windows, self.mesh), dim=0)
            windows = gathered[torch.from_numpy(np.argsort(order)).to(gathered.device)]
        voxels = self._merge(windows, mode)
        _sync(self.device)
        self.timings.update(stage1_s=time.perf_counter() - t0,
                            windows=sum(len(g) for g in groups[rank::size]))
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

    def _chunks(self, voxels: torch.Tensor):
        """(T, 20, H, W) -> per chunk of stage2_batch_size frames: (index,
        zero-padded (chunk, 2, 10, H, W) voxels, real frames, int64 offsets
        of its frames in µs)."""
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
        for i in range(n_chunks):
            base = i * chunk
            offsets64 = ((np.arange(chunk) + base) / cfg.fps * 1e6).astype(np.int64)
            yield (i, v[base:base + chunk].contiguous(), min(chunk, t - base), offsets64)

    def voxels_to_events(self, voxels: torch.Tensor) -> List[np.ndarray]:
        """Merged voxels (T, 20, H, W) -> per-frame event recarrays with
        absolute int64 µs timestamps, through the EventStream route."""
        cfg = self.config
        recs: List[np.ndarray] = []
        scfg = dataclasses.replace(cfg.sampler, fps=cfg.fps)
        for i, v, _, offsets64 in self._chunks(voxels):
            s = sample_events(v, make_draw(self.seed, i, v.device), scfg)
            recs.extend(to_recarrays(s, offsets64))
        return recs[:voxels.shape[0]]

    def voxels_to_event_stream(self, voxels: torch.Tensor) -> Optional[np.ndarray]:
        """Merged voxels (T, 20, H, W) -> ONE structured event stream with
        the per-frame i/fps offsets applied. Chunks of stage2_batch_size
        frames are sampled with draws seeded from (seed, chunk index).
        Under a mesh, chunk i runs on rank i mod n and rank 0 gathers the
        stream; the other ranks return None."""
        cfg = self.config
        rank, size = self._ranks()
        t0 = time.perf_counter()
        parts = []
        for i, v, frames, offsets64 in self._chunks(voxels):
            if i % size != rank:
                continue
            base_us = int(offsets64[0])
            rel_t = torch.from_numpy((offsets64 - base_us).astype(np.int32)).to(v.device)
            parts.append(chunk_events(v, make_draw(self.seed, i, v.device), rel_t, frames,
                                      cfg.sampler, cfg.fps, base_us=base_us))
        self.timings.update(stage2_s=time.perf_counter() - t0, chunks=len(parts))
        gathered = gather_to_lead(parts, self.mesh)
        if gathered is None:
            return None
        # rank r holds chunks r, r + n, ...: back to chunk order
        parts = [gathered[i % size][i // size]
                 for i in range(sum(len(g) for g in gathered))]
        return np.concatenate(parts) if parts else np.zeros(0, EVENT_DTYPE)

    # -- full runs --------------------------------------------------------

    def _write_preview(self, frames: np.ndarray, out_folder: str, output_name: str,
                       result: dict) -> None:
        from v2ce_toolbox_tpu_torch.io.video import write_video

        cfg = self.config
        vis_color = "rgb" if cfg.vis_keep_polarity else "gray"
        ef_path = op.join(out_folder, f"{cfg.infer_type}-{output_name}-pred_ef_{vis_color}.mp4")
        write_video(frames, ef_path, cfg.fps)
        result["event_frame_video"] = ef_path

    def _finish(self, event_stream: Optional[np.ndarray], out_folder: str, output_name: str,
                result: dict, n_frames: int, t_start: float, tag: str = "") -> dict:
        """Write the npz (rank 0; another rank, holding no stream, writes
        nothing and returns its timings)."""
        if event_stream is None:
            result.update(wall_time_s=time.time() - t_start, timings=dict(self.timings))
            return result
        ev_path = op.join(out_folder, f"{output_name}-events.npz")
        np.savez(ev_path, event_stream=event_stream)
        result.update(event_stream_path=ev_path, num_events=int(event_stream.shape[0]),
                      num_frames=n_frames, wall_time_s=time.time() - t_start,
                      timings=dict(self.timings))
        logger.info("%s%d frames -> %d events in %.2fs", tag, n_frames,
                    result["num_events"], result["wall_time_s"])
        return result

    def _open(self, input_video_path: Optional[str], image_folder: Optional[str]):
        """(vidcap or None, image paths or None, frame count)."""
        from v2ce_toolbox_tpu_torch.io.video import VideoReader, list_image_frames

        cfg = self.config
        if (input_video_path is None) == (image_folder is None):
            raise ValueError("give exactly one of input_video_path and image_folder")
        if image_folder is not None:
            paths = list_image_frames(image_folder, cfg.max_frame_num)
            return None, paths, len(paths)
        vidcap = VideoReader(input_video_path, color_mode="GRAY")
        if cfg.max_frame_num and vidcap.frame_count > cfg.max_frame_num:
            vidcap.frame_count = cfg.max_frame_num
        return vidcap, None, vidcap.frame_count

    def run(self, *, input_video_path: Optional[str] = None,
            image_folder: Optional[str] = None, out_folder: str = "./output",
            out_name_suffix: str = "") -> dict:
        """Full CLI run; returns paths, counts and timings (under a mesh,
        rank 0 writes and returns the paths; every rank its timings)."""
        cfg = self.config
        lead = self.mesh is None or self.mesh.is_lead
        vidcap, paths, n_frames = self._open(input_video_path, image_folder)
        if lead:
            os.makedirs(out_folder, exist_ok=True)
        output_name = _output_name(cfg, input_video_path, image_folder, out_name_suffix)
        self.timings = {}
        t_start = time.time()
        try:
            voxels = self.video_to_voxels(vidcap=vidcap, image_paths=paths)
        finally:
            if vidcap is not None:
                vidcap.close()

        t_, c_, h_, w_ = voxels.shape
        result = {"voxels_shape": (t_, h_, w_, c_)}   # logical, channels-last
        if cfg.write_event_frame_video and lead:
            frames = render_event_frames_cmajor(
                voxels, ceil=float(cfg.ceil),
                upper_bound_percentile=cfg.upper_bound_percentile,
                keep_polarity=cfg.vis_keep_polarity)
            self._write_preview(frames, out_folder, output_name, result)
        event_stream = self.voxels_to_event_stream(voxels)
        return self._finish(event_stream, out_folder, output_name, result, n_frames,
                            t_start)

    def run_streaming(self, *, input_video_path: Optional[str] = None,
                      image_folder: Optional[str] = None, out_folder: str = "./output",
                      out_name_suffix: str = "") -> dict:
        """Streaming CLI run: each seq_len-frame window flows decode ->
        forward -> sampler -> wire flatten -> host decode, and only the
        per-polarity event-frame sums stay on the device for the preview's
        global percentile bound. Memory is O(window), not O(video).

        Event totals equal run()'s (emission counts are a deterministic
        function of the voxels; the last window re-emits only its
        non-overlapping tail, like the window merge). Window i draws from
        `make_draw(seed, i, device)`, so the timestamps differ from run()'s
        in distribution only. Under a mesh, window i runs on rank i mod n;
        rank 0 gathers the records and the event-frame sums in window order
        and writes."""
        cfg = self.config
        rank, size = self._ranks()
        vidcap, paths, frame_count = self._open(input_video_path, image_folder)
        if rank == 0:
            os.makedirs(out_folder, exist_ok=True)
        output_name = _output_name(cfg, input_video_path, image_folder, out_name_suffix)
        self.timings = {"stage1_s": 0.0, "stage2_s": 0.0}
        t_start = time.time()
        starts, mode = plan_windows(frame_count, cfg.seq_len)
        mine = []               # (window, records, event-frame sums, (h, w)) of this rank
        try:
            for i, start in enumerate(starts):
                if i % size != rank:
                    continue
                t0 = time.perf_counter()
                vox = self._forward(self._read_window(start, vidcap, paths)[None])[0]
                _sync(self.device)
                t1 = time.perf_counter()
                h_out, w_out = vox.shape[-2:]
                v = vox.reshape(cfg.seq_len, 2, vox.shape[1] // 2, h_out, w_out).contiguous()
                skip = (cfg.seq_len - mode) if (i == len(starts) - 1 and mode) else 0
                ef = v.sum(dim=2)[skip:] if cfg.write_event_frame_video else None
                if ef is not None and self.mesh is not None:
                    ef = ef.cpu()
                offsets64 = ((np.arange(cfg.seq_len) + int(start)) / cfg.fps
                             * 1e6).astype(np.int64)
                base_us = int(offsets64[0])          # window-rebased: any length
                rel_t = torch.from_numpy((offsets64 - base_us).astype(np.int32)).to(v.device)
                rec = chunk_events(v, make_draw(self.seed, i, v.device), rel_t, cfg.seq_len,
                                   cfg.sampler, cfg.fps, skip_lead=skip, base_us=base_us)
                mine.append((i, rec, ef, (h_out, w_out)))
                self.timings["stage1_s"] += t1 - t0
                self.timings["stage2_s"] += time.perf_counter() - t1
        finally:
            if vidcap is not None:
                vidcap.close()
        self.timings.update(windows=len(mine), chunks=len(mine))
        gathered = gather_to_lead(mine, self.mesh)
        if gathered is None:
            return self._finish(None, out_folder, output_name, {}, frame_count, t_start)
        windows = sorted((w for g in gathered for w in g), key=lambda w: w[0])
        h_out, w_out = windows[-1][3]
        result = {"voxels_shape": (frame_count - 1, h_out, w_out, cfg.model.out_channels)}
        if cfg.write_event_frame_video:
            frames = render_event_frames_from_sums(
                torch.cat([w[2].to(self.device) for w in windows], dim=0), ceil=float(cfg.ceil),
                upper_bound_percentile=cfg.upper_bound_percentile,
                keep_polarity=cfg.vis_keep_polarity)
            self._write_preview(frames, out_folder, output_name, result)
        parts = [w[1] for w in windows]
        event_stream = np.concatenate(parts) if parts else np.zeros(0, EVENT_DTYPE)
        return self._finish(event_stream, out_folder, output_name, result, frame_count,
                            t_start, tag="[streaming] ")
