"""Fixed-capacity event-graph pooling: voxel-grid clustering, cluster
max-pooling of node features, mean-pooling of positions and the edge
remap with coalesce, the surface of torch-geometric's `voxel_grid`,
`max_pool_x` and `max_pool` that the reference's `MaxPoolingX` and
`MaxPooling` wrap.

The contract is the JAX package's (`v2ce_toolbox_tpu/models/graph_pool.py`):
every output keeps its input's capacity, with a live count returned as a
0-dim tensor on the inputs' device; dead rows are zero, and dead ids and
edge endpoints are INVALID (2**31 - 1, sorting after every live id).
Inputs may carry a validity mask. The ops run where their tensors are:
`torch.sort` (stable) for the relabel and the edge coalesce, and
`scatter_reduce` / `index_add_` for the segment maxima and sums. Ids,
counts, `perm`, edges and max-pooled features are exact; the float sums
(the `pos` mean, `edge_attr`) come from atomics on the card, so their
order, and their last bits, may differ from run to run there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

INVALID = 2**31 - 1
_BIG = 3.4e38


def _as_size(size: Union[float, Sequence[float], torch.Tensor], d: int,
             device) -> torch.Tensor:
    s = torch.as_tensor(size, dtype=torch.float32, device=device).reshape(-1)
    return s.expand(d)


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Row-wise max of x over segments 0..n-1 of `seg` (ids outside
    [0, n) are dropped, as XLA's segment ops drop them); empty segments
    hold 0."""
    seg = torch.where((seg >= 0) & (seg < n), seg, n).long()
    idx = seg.view(-1, *(1,) * (x.dim() - 1)).expand_as(x)
    out = torch.zeros((n + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, idx, x, "amax", include_self=False)[:n]


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    seg = torch.where((seg >= 0) & (seg < n), seg, n).long()
    out = torch.zeros((n + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)[:n]


def _gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] with JAX's index rule: negative indices count from the
    end, then every index is clamped into range."""
    n = values.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return values[idx.long()]


def voxel_grid(pos: torch.Tensor, size, batch: Optional[torch.Tensor] = None,
               start=None, end=None, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cluster ids (int32) from quantizing positions onto a regular grid,
    torch_cluster.grid_cluster's convention: coordinate d of point i is
    floor((pos[i, d] - start[d]) / size[d]), ids ravel with dim 0
    fastest, and the batch index rides as the slowest coordinate (id =
    batch * n_voxels + raveled coordinate). start / end default to the
    per-dim min / max over the valid points. Invalid points get INVALID.
    The division is by a tensor (CUDA torch would multiply by the
    reciprocal of a Python scalar)."""
    n, d = pos.shape
    dev = pos.device
    size = _as_size(size, d, dev)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    p = pos.float()
    live = valid[:, None]
    start = (torch.where(live, p, _BIG).amin(0) if start is None
             else _as_size(start, d, dev))
    end = (torch.where(live, p, -_BIG).amax(0) if end is None else _as_size(end, d, dev))
    coord = torch.floor((p - start) / size).to(torch.int32)
    dims = torch.floor((end - start) / size).to(torch.int32) + 1
    stride = torch.cat([torch.ones(1, dtype=torch.int32, device=dev),
                        torch.cumprod(dims[:-1], 0, dtype=torch.int32)])
    ids = (coord * stride).sum(1, dtype=torch.int32)
    if batch is not None:
        ids = ids + batch.to(torch.int32) * torch.prod(dims, dtype=torch.int32)
    return torch.where(valid, ids, INVALID)


def consecutive_cluster(ids: torch.Tensor):
    """Relabel cluster ids to 0..K-1 in ascending-id order; INVALID stays
    INVALID. Returns (relabeled ids, K, perm): perm[k] is the smallest
    index of a member of cluster k for k < K. For k >= K, perm is
    2147483647, as in the JAX package, where it comes out of int32
    wrap-around in -segment_max(...) - 1 over the empty segments; here it
    is written directly. E.g. ids [5, 3, 5, INVALID, 9, 3] give perm
    [1, 0, 4, 2147483647, 2147483647, 2147483647]."""
    n = ids.shape[0]
    dev = ids.device
    s, order = torch.sort(ids, stable=True)
    live = s != INVALID
    first = live & torch.cat([torch.ones(1, dtype=torch.bool, device=dev), s[1:] != s[:-1]])
    rank = (torch.cumsum(first, 0) - 1).to(torch.int32)
    out = torch.zeros(n, dtype=torch.int32, device=dev).scatter(0, order, rank)
    out = torch.where(ids == INVALID, INVALID, out)
    k = first.sum().to(torch.int32)
    seg = torch.where(ids == INVALID, n, out).long()
    members = torch.full((n + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, torch.arange(n, device=dev), "amin", include_self=False)[:n]
    perm = torch.where(torch.arange(n, device=dev) < k, members, INVALID).to(torch.int32)
    return out, k, perm


def _seg(ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    return torch.where(ids == INVALID, n_seg, ids)


def _pooled_batch(batch, perm, k, n):
    if batch is None:
        return None
    return torch.where(torch.arange(n, device=perm.device) < k, _gather(batch, perm), 0)


def max_pool_x(cluster: torch.Tensor, x: torch.Tensor, batch: Optional[torch.Tensor] = None,
               size: Optional[int] = None):
    """Max-pool node features by cluster: consecutive relabel, then the
    feature-wise max of each cluster; the output keeps the node capacity
    with rows K.. zero. Returns (x_out, batch_out, K). The fixed-`size`
    variant is max_pool_x_sized."""
    n = x.shape[0]
    if size is not None:
        raise ValueError(
            "max_pool_x(size=...) needs a static batch count; call "
            "max_pool_x_sized(cluster, x, batch, num_graphs, size)")
    ids, k, perm = consecutive_cluster(cluster)
    live = (torch.arange(n, device=x.device) < k)[:, None]
    pooled = torch.where(live, _segment_max(x, _seg(ids, n), n), 0)
    return pooled, _pooled_batch(batch, perm, k, n), k


def max_pool_x_sized(cluster: torch.Tensor, x: torch.Tensor, batch: torch.Tensor,
                     num_graphs: int, size: int) -> torch.Tensor:
    """Output (num_graphs * size, F): row b * size + v is the max over the
    points of graph b with per-graph voxel id v, empty rows zero.
    `cluster` holds per-graph ids in [0, size) (voxel_grid without the
    batch offset)."""
    rows = num_graphs * size
    seg = torch.where(cluster == INVALID, rows, batch.to(torch.int32) * size + cluster)
    out = _segment_max(x, seg, rows)
    count = _segment_sum(torch.ones_like(seg, dtype=torch.int32), seg, rows)
    return torch.where((count == 0)[:, None], 0, out)


def pool_edge(cluster: torch.Tensor, edge_index: torch.Tensor,
              edge_attr: Optional[torch.Tensor] = None,
              edge_valid: Optional[torch.Tensor] = None):
    """Remap edges onto cluster ids, drop self-loops and dead endpoints,
    coalesce duplicates (summing attributes), in (src, dst) order.
    The output keeps (2, E) with an INVALID tail; returns
    (edge_index_out, edge_attr_out, n_edges). The coalesce sorts one
    int64 key, src * 2**32 + (dst + 2**31): the JAX package's (src, dst)
    lexsort."""
    e = edge_index.shape[1]
    dev = edge_index.device
    if edge_valid is None:
        edge_valid = torch.ones(e, dtype=torch.bool, device=dev)
    src = torch.where(edge_valid, _gather(cluster, edge_index[0]), INVALID)
    dst = torch.where(edge_valid, _gather(cluster, edge_index[1]), INVALID)
    live = edge_valid & (src != dst) & (src != INVALID) & (dst != INVALID)
    sk = torch.where(live, src, INVALID).long()
    dk = torch.where(live, dst, INVALID).long()
    _, order = torch.sort(sk * 2**32 + (dk + 2**31), stable=True)
    ss, ds = sk[order], dk[order]
    lives = ss != INVALID
    first = lives & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               (ss[1:] != ss[:-1]) | (ds[1:] != ds[:-1])])
    rank = torch.cumsum(first, 0) - 1                   # unique-edge slot
    n_out = first.sum().to(torch.int32)
    slot = torch.where(first, rank, e)
    out_idx = torch.full((2, e + 1), INVALID, dtype=torch.int32, device=dev)
    out_idx[0].scatter_(0, slot, ss.to(torch.int32))
    out_idx[1].scatter_(0, slot, ds.to(torch.int32))
    attr_out = None
    if edge_attr is not None:
        seg = torch.where(lives, rank, e)
        attr_out = _segment_sum(torch.where(lives[:, None], edge_attr[order], 0), seg, e)
    return out_idx[:, :e], attr_out, n_out


def max_pool(cluster: torch.Tensor, x: torch.Tensor, pos: torch.Tensor,
             edge_index: torch.Tensor, batch: Optional[torch.Tensor] = None,
             edge_attr: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None,
             edge_valid: Optional[torch.Tensor] = None):
    """Graph coarsening by cluster: features max-pooled, positions
    mean-pooled, edges remapped, de-self-looped and coalesced. Node
    outputs keep the input capacity with K live rows. Returns (x_out,
    pos_out, batch_out, edge_index_out, edge_attr_out, k_nodes,
    n_edges)."""
    n = x.shape[0]
    ids, k, perm = consecutive_cluster(
        cluster if valid is None else torch.where(valid, cluster, INVALID))
    seg = _seg(ids, n)
    live_row = (torch.arange(n, device=x.device) < k)[:, None]
    x_out = torch.where(live_row, _segment_max(x, seg, n), 0)
    cnt = _segment_sum(torch.ones(n, dtype=pos.dtype, device=pos.device), seg, n)
    pos_out = torch.where(live_row, _segment_sum(pos, seg, n)
                          / torch.clamp(cnt, min=1)[:, None], 0)
    e_idx, e_attr, n_e = pool_edge(ids, edge_index, edge_attr, edge_valid)
    return x_out, pos_out, _pooled_batch(batch, perm, k, n), e_idx, e_attr, k, n_e


class MaxPoolingX(nn.Module):
    """voxel_grid over every pos dim, then the fixed-size max_pool_x:
    output (num_graphs * size, F)."""

    def __init__(self, voxel_size: List[float], size: int):
        super().__init__()
        self.voxel_size = voxel_size
        self.size = size

    def forward(self, x, pos, batch=None, num_graphs: int = 1, valid=None):
        if batch is None:
            batch = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        # per-graph ids: max_pool_x_sized offsets by b * size itself
        cluster = voxel_grid(pos, self.voxel_size, batch=None, valid=valid)
        return max_pool_x_sized(cluster, x, batch, num_graphs, self.size)

    def __repr__(self):
        return f"{self.__class__.__name__}(voxel_size={self.voxel_size}, size={self.size})"


class MaxPooling(nn.Module):
    """voxel_grid over pos[:, :2], then the graph max_pool; `transform`
    is an optional callable on the output tuple."""

    def __init__(self, size: List[float], transform=None):
        super().__init__()
        self.voxel_size = list(size)
        self.transform = transform

    def forward(self, x, pos, batch=None, edge_index=None, valid=None, edge_valid=None,
                edge_attr=None):
        assert edge_index is not None, "edge_index must not be None"
        cluster = voxel_grid(pos[:, :2], self.voxel_size, batch=batch, valid=valid)
        out = max_pool(cluster, x, pos, edge_index, batch=batch, edge_attr=edge_attr,
                       valid=valid, edge_valid=edge_valid)
        if self.transform is not None:
            out = self.transform(out)
        return out

    def __repr__(self):
        return f"{self.__class__.__name__}(voxel_size={self.voxel_size})"
