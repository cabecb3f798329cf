"""K13-K16: the stage-2 roofline probes of the JAX package's
`tools/perf_probe.py:probe_stage2_roofline`, on an int32 (r, n_chunks, sc,
128) array (the chain compaction's grid: 144 rows of 11 chunks of 16,384
keys, sc = 128).

  * `op_chain(x, k)` (K13, `perf_probe.py:2510`): each (sc, 128) tile runs
    k // 4 rounds of lane-roll by 1, XOR with the lane index, sublane-roll
    by 1, +1 where lane >= 64; returns (r, sc, 128), each row's last-chunk
    tile;
  * `op_chain_ilp(x, k)` (K14, `:2554`): the same on 4 chains x + i,
    k // 16 rounds each; returns the XOR of the four;
  * `stream_copy(x)` (K15, `:2597`) and `stream_copy_row(x)` (K16,
    `:2626`): x copied in one block per (row, chunk), or per row (K16
    through a ring of bulk copies, its output allocated at the source's
    16-byte phase so that the bulk copies apply to both).

The closures of the JAX probe become functions here. On a CPU tensor each
runs its plain twin (`torch.roll`, `clone()`); on a CUDA tensor it launches
`csrc/roofline.cu` (K13, K14) or `csrc/stream_copy.cu` (K15, K16), or
raises. The kernels are identical to the twins, integers only.
"""

from __future__ import annotations

import torch

from v2ce_toolbox_tpu_torch.ops import _cuda

LANES = 128
launches = {"op_chain": 0, "op_chain_ilp": 0, "stream_copy": 0, "stream_copy_row": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[3] != LANES or x.dtype != torch.int32:
        raise ValueError(f"{name}: expected an int32 (r, n_chunks, sc, {LANES}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cpu" and x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")


def _rounds(tiles, rounds):
    lane = torch.arange(LANES, dtype=torch.int32, device=tiles[0].device)
    for _ in range(rounds):
        tiles = [torch.roll(t, 1, dims=-1) for t in tiles]
        tiles = [t ^ lane for t in tiles]
        tiles = [torch.roll(t, 1, dims=-2) for t in tiles]
        tiles = [torch.where(lane < 64, t, t + 1) for t in tiles]
    return tiles


def _op_chain_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of `op_chain` (any device): only the last chunk is stored."""
    return _rounds([x[:, -1]], k // 4)[0]


def _op_chain_ilp_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of `op_chain_ilp` (any device)."""
    t = _rounds([x[:, -1] + i for i in range(4)], k // 16)
    return t[0] ^ t[1] ^ t[2] ^ t[3]


def _launch_chain(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    r, n_chunks, sc, _ = x.shape
    if k < 0:
        raise ValueError(f"{name}: k={k} < 0")
    xc = x.contiguous()
    out = torch.empty((r, sc, LANES), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_cuda.lib(), f"v2ce_{name}")(xc.data_ptr(), out.data_ptr(), r, n_chunks,
                                                   sc, k, _cuda.stream_of(x))
    _cuda.check(err, name)
    launches[name] += 1
    return out


def op_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """K13: k // 4 rounds of the serial op chain on every tile; each row's
    last-chunk tile (r, sc, 128)."""
    _check("op_chain", x)
    if x.device.type == "cpu":
        return _op_chain_torch(x, k)
    return _launch_chain("op_chain", x, k)


def op_chain_ilp(x: torch.Tensor, k: int) -> torch.Tensor:
    """K14: k // 16 rounds of 4 independent chains x + i on every tile; the
    XOR of the four last-chunk tiles (r, sc, 128)."""
    _check("op_chain_ilp", x)
    if x.device.type == "cpu":
        return _op_chain_ilp_torch(x, k)
    return _launch_chain("op_chain_ilp", x, k)


def _stream_copy_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of `stream_copy` and `stream_copy_row` (any device)."""
    return x.clone()


def _same_phase_empty(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like the contiguous x whose address lies at x's
    16-byte phase (a view into a slightly longer buffer where x is not
    16-byte aligned)."""
    if x.data_ptr() % 16 == 0:
        return torch.empty_like(x)
    per = 16 // x.element_size()
    buf = torch.empty(x.numel() + per, dtype=x.dtype, device=x.device)
    off = (x.data_ptr() - buf.data_ptr()) % 16 // x.element_size()
    return buf[off:off + x.numel()].view(x.shape)


def _launch_copy(name: str, x: torch.Tensor, *dims: int) -> torch.Tensor:
    xc = x.contiguous()
    out = _same_phase_empty(xc) if name == "stream_copy_row" else torch.empty_like(xc)
    with torch.cuda.device(x.device):
        err = getattr(_cuda.lib(), f"v2ce_{name}")(xc.data_ptr(), out.data_ptr(), *dims,
                                                   _cuda.stream_of(x))
    _cuda.check(err, name)
    launches[name] += 1
    return out


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """K15: a copy of x, one block per (row, chunk) of sc x 128 keys."""
    _check("stream_copy", x)
    if x.device.type == "cpu":
        return _stream_copy_torch(x)
    r, n_chunks, sc, _ = x.shape
    return _launch_copy("stream_copy", x, r, n_chunks, sc * LANES * 4)


def stream_copy_row(x: torch.Tensor) -> torch.Tensor:
    """K16: a copy of x, one block per row of n_chunks x sc x 128 keys."""
    _check("stream_copy_row", x)
    if x.device.type == "cpu":
        return _stream_copy_torch(x)
    r, n_chunks, sc, _ = x.shape
    return _launch_copy("stream_copy_row", x, r, n_chunks * sc * LANES * 4)
