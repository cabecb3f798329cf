"""Row compaction (K2), sorted-row merge (K3) and the prefix append (K5),
each with its plain twin.

`compact_rows`, `merge_sorted_rows` and `append_rows` are the port's
counterparts of `v2ce_toolbox_tpu/ops/compact_pallas.py`. On a CPU tensor
they run their plain-torch twins; on a CUDA tensor they launch the
hand-written kernels of `csrc/compact_rows.cu` and `csrc/merge_rows.cu`
(K5 is K3's merge of all R rows into one, with its own entry and launch
count), or raise. There is no fallback from the kernels to the twins.

`compact_rows` keeps the JAX package's two algorithms and its default,
algo="window" (K2w, `_compact_kernel`) beside algo="place" (K2,
`_compact_kernel2`). They share one contract, so both launch K2's kernel,
each through its own C entry and launch count; the TPU's 2-chunk roll
butterfly, the only difference, is a VMEM tiling artifact. The port's
sampler and wire format pass algo="place", as the JAX package's do.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from v2ce_toolbox_tpu_torch.ops import _cuda

INVALID = 2 ** 31 - 1          # int32 max marks an empty slot
_TILE = 8192                   # keys per block of csrc/compact_rows.cu

# launches of each kernel since the last reset (the wrappers add one per
# call that reaches the card)
launches = {"compact_rows": 0, "compact_rows_window": 0, "merge_sorted_rows": 0,
            "append_rows": 0}
ALGOS = ("window", "place")

Out = Tuple[torch.Tensor, Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_cuda_int32(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected a contiguous int32 tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


# ---------------------------------------------------------------------------
# K2: stable per-row compaction
# ---------------------------------------------------------------------------

def compact_rows_torch(keys: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                       *, cap: int, chunk: int, algo: str = "window") -> Out:
    """Plain twin of `compact_rows` (any device), for either algo."""
    r, n = keys.shape
    capp = _round_up(cap, chunk)
    valid = keys != INVALID
    pos = torch.cumsum(valid, dim=1, dtype=torch.int64) - 1
    total = valid.sum(dim=1, dtype=torch.int32)
    rows, cols = torch.nonzero(valid & (pos < capp), as_tuple=True)
    dst = pos[rows, cols]
    out_k = torch.full((r, capp), INVALID, dtype=torch.int32, device=keys.device)
    out_k[rows, dst] = keys[rows, cols]
    out_p = []
    for p in payloads:
        o = torch.zeros((r, capp), dtype=torch.int32, device=keys.device)
        o[rows, dst] = p[rows, cols]
        out_p.append(o)
    return out_k, tuple(out_p), torch.clamp(total, max=capp), total


def compact_rows(keys: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                 *, cap: int, chunk: int, algo: str = "window") -> Out:
    """Stable per-row compaction: elements with key != INVALID move to the
    row front in order, with their payloads (counterpart of
    compact_pallas.compact_rows, `compact_pallas.py:721`).

    Args:
      keys: (R, N) int32; INVALID marks empty slots.
      payloads: zero or one int32 arrays of the same shape.
      cap: kept valids per row, rounded up to a multiple of `chunk` (cap'):
        the TPU kernel drops whole chunks, which keeps exactly the first
        cap' valids.
      algo: "window" (K2w) or "place" (K2): the same result, each with its
        own C entry and launch count. "window" pads N to a multiple of
        `chunk` with INVALID first, as the JAX wrapper does.
    Returns:
      (out_keys (R, cap'), out_payloads, kept (R,), total (R,)): INVALID
      keys / zero payloads past kept = min(total, cap'); total - kept is
      the exact drop.
    """
    if chunk % 128:
        raise ValueError(f"chunk={chunk} must be a multiple of 128")
    if algo not in ALGOS:
        raise ValueError(f"algo={algo!r}: expected one of {ALGOS}")
    if keys.device.type == "cpu":
        return compact_rows_torch(keys, payloads, cap=cap, chunk=chunk, algo=algo)
    payloads = tuple(payloads)
    if len(payloads) > 1:
        raise ValueError("the compact_rows kernel routes at most one payload")
    r, n = keys.shape
    check_cuda_int32("compact_rows keys", keys, (r, n))
    for p in payloads:
        check_cuda_int32("compact_rows payload", p, (r, n))
    if algo == "window" and n % chunk:
        pad = chunk - n % chunk
        keys = torch.nn.functional.pad(keys, (0, pad), value=INVALID)
        payloads = tuple(torch.nn.functional.pad(p, (0, pad)) for p in payloads)
        n += pad
    capp = _round_up(cap, chunk)
    if r > 65535 or n > (1 << 31) - _TILE or capp > (1 << 31) - _TILE:
        raise ValueError(f"compact_rows: ({r}, {n}) -> cap {capp} exceeds the kernel's "
                         "limits")
    out_k = torch.empty((r, capp), dtype=torch.int32, device=keys.device)
    out_p = tuple(torch.empty_like(out_k) for _ in payloads)
    tile_counts = torch.empty((r, -(-n // _TILE)), dtype=torch.int32, device=keys.device)
    kept = torch.empty((r,), dtype=torch.int32, device=keys.device)
    total = torch.empty_like(kept)
    name = "compact_rows_window" if algo == "window" else "compact_rows"
    with torch.cuda.device(keys.device):
        err = getattr(_cuda.lib(), f"v2ce_{name}")(
            keys.data_ptr(), payloads[0].data_ptr() if payloads else None,
            out_k.data_ptr(), out_p[0].data_ptr() if out_p else None,
            tile_counts.data_ptr(), kept.data_ptr(), total.data_ptr(), r, n, capp,
            _cuda.stream_of(keys))
    _cuda.check(err, name)
    launches[name] += 1
    return out_k, out_p, kept, total


# ---------------------------------------------------------------------------
# K3: concatenate the valid prefixes of nb consecutive rows
# ---------------------------------------------------------------------------

def merge_sorted_rows_torch(keys: torch.Tensor,
                            payloads: Sequence[torch.Tensor] = (),
                            *, nb: int, cap: int) -> Out:
    """Plain twin of `merge_sorted_rows` (any device)."""
    r, wd = keys.shape
    g = r // nb
    lengths = (keys != INVALID).sum(dim=1, dtype=torch.int64)
    per_group = lengths.view(g, nb)
    offsets = (torch.cumsum(per_group, dim=1) - per_group).reshape(r)
    col = torch.arange(wd, device=keys.device)
    dst = offsets[:, None] + col[None, :]
    take = (col[None, :] < lengths[:, None]) & (dst < cap)
    rows, cols = torch.nonzero(take, as_tuple=True)
    grp = rows // nb
    d = dst[rows, cols]
    out_k = torch.full((g, cap), INVALID, dtype=torch.int32, device=keys.device)
    out_k[grp, d] = keys[rows, cols]
    out_p = []
    for p in payloads:
        o = torch.zeros((g, cap), dtype=torch.int32, device=keys.device)
        o[grp, d] = p[rows, cols]
        out_p.append(o)
    total = per_group.sum(dim=1).to(torch.int32)
    return out_k, tuple(out_p), torch.clamp(total, max=cap), total


def merge_sorted_rows(keys: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                      *, nb: int, cap: int) -> Out:
    """Concatenate the valid prefixes of nb consecutive rows into one row
    (counterpart of compact_pallas.merge_sorted_rows, `compact_pallas.py:556`).
    A row's length is its count of non-INVALID keys, which the callers keep
    as a prefix.

    Args:
      keys: (R, W) int32, R % nb == 0, W % 128 == 0.
      payloads: zero or one int32 arrays of the same shape.
      cap: output row capacity (a multiple of 128).
    Returns:
      (out_keys (R // nb, cap), out_payloads, kept, total): kept =
      min(total, cap), INVALID keys / zero payloads past it.
    """
    r, wd = keys.shape
    if r % nb or wd % 128 or cap % 128:
        raise ValueError(f"merge_sorted_rows needs R % nb == 0 and W, cap "
                         f"multiples of 128; got R={r} nb={nb} W={wd} cap={cap}")
    if keys.device.type == "cpu":
        return merge_sorted_rows_torch(keys, payloads, nb=nb, cap=cap)
    payloads = tuple(payloads)
    if len(payloads) > 1:
        raise ValueError("the merge kernel routes at most one payload")
    check_cuda_int32("merge_sorted_rows keys", keys, (r, wd))
    for p in payloads:
        check_cuda_int32("merge_sorted_rows payload", p, (r, wd))
    g = r // nb
    if r > 65535 or g > 65535:
        raise ValueError(f"merge_sorted_rows: {r} rows exceed the grid limit")
    out_k = torch.empty((g, cap), dtype=torch.int32, device=keys.device)
    out_p = tuple(torch.empty_like(out_k) for _ in payloads)
    lengths = torch.empty((r,), dtype=torch.int32, device=keys.device)
    kept = torch.empty((g,), dtype=torch.int32, device=keys.device)
    total = torch.empty_like(kept)
    with torch.cuda.device(keys.device):
        err = _cuda.lib().v2ce_merge_rows(
            keys.data_ptr(), payloads[0].data_ptr() if payloads else None,
            out_k.data_ptr(), out_p[0].data_ptr() if out_p else None,
            lengths.data_ptr(), kept.data_ptr(), total.data_ptr(),
            r, wd, nb, cap, _cuda.stream_of(keys))
    _cuda.check(err, "merge_sorted_rows")
    launches["merge_sorted_rows"] += 1
    return out_k, out_p, kept, total


# ---------------------------------------------------------------------------
# K5: collapse prefix-packed rows into one stream
# ---------------------------------------------------------------------------

def append_rows_torch(keys: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                      *, cap: int, chunk: int) -> Out:
    """Plain twin of `append_rows` (any device): the merge of all R rows."""
    return merge_sorted_rows_torch(keys, payloads, nb=keys.shape[0],
                                   cap=_round_up(cap, chunk))


def append_rows(keys: torch.Tensor, payloads: Sequence[torch.Tensor] = (),
                *, cap: int, chunk: int = 8192) -> Out:
    """Collapse R prefix-packed rows into one front-packed row (counterpart
    of compact_pallas.append_rows, `compact_pallas.py:632`): the valid keys
    of each row must form a prefix, as in per-frame event buffers.

    Args:
      keys: (R, W) int32, any W; INVALID marks empty slots.
      payloads: zero or one int32 arrays of the same shape.
      cap: output capacity, rounded up to a multiple of `chunk` (cap'): the
        TPU kernel drops whole chunks, which keeps exactly the first cap'
        valids.
    Returns:
      (out_keys (1, cap'), out_payloads, kept (1,), total (1,)): INVALID
      keys / zero payloads past kept = min(total, cap').
    """
    if chunk % 128:
        raise ValueError(f"chunk={chunk} must be a multiple of 128")
    if keys.device.type == "cpu":
        return append_rows_torch(keys, payloads, cap=cap, chunk=chunk)
    payloads = tuple(payloads)
    if len(payloads) > 1:
        raise ValueError("the append_rows kernel routes at most one payload")
    r, wd = keys.shape
    check_cuda_int32("append_rows keys", keys, (r, wd))
    for p in payloads:
        check_cuda_int32("append_rows payload", p, (r, wd))
    capp = _round_up(cap, chunk)
    if r > 65535 or r * wd >= 1 << 31 or capp >= 1 << 31:
        raise ValueError(f"append_rows: ({r}, {wd}) -> {capp} exceeds the kernel's limits")
    dev = keys.device
    out_k = torch.empty((1, capp), dtype=torch.int32, device=dev)
    out_p = tuple(torch.empty_like(out_k) for _ in payloads)
    lengths = torch.empty((r,), dtype=torch.int32, device=dev)
    kept = torch.empty((1,), dtype=torch.int32, device=dev)
    total = torch.empty_like(kept)
    with torch.cuda.device(dev):
        err = _cuda.lib().v2ce_append_rows(
            keys.data_ptr(), payloads[0].data_ptr() if payloads else None,
            out_k.data_ptr(), out_p[0].data_ptr() if out_p else None,
            lengths.data_ptr(), kept.data_ptr(), total.data_ptr(),
            r, wd, capp, _cuda.stream_of(keys))
    _cuda.check(err, "append_rows")
    launches["append_rows"] += 1
    return out_k, out_p, kept, total
