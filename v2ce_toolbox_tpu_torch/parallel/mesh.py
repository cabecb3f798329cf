"""Data parallelism over `torch.distributed`: one process a rank, one device
a rank.

The JAX package's `parallel/mesh.py` in torch. There one program is jitted
over a 'data' mesh axis and XLA inserts the collectives; here each rank is
a process holding one device, and the collectives are explicit:

  * a global batch splits into contiguous blocks of axis 0, one a rank (the
    JAX `P("data")`, `shard_batch`), and every rank walks the same global
    order;
  * gradients are averaged in one flattened all_reduce (`average_gradients`),
    so every optimizer sees the gradient of the global-batch loss;
  * BatchNorm takes its statistics over the global batch through an
    all_reduce with autograd (`models/layers._FlaxTrainBN`);
  * host results (event records, predictions) are gathered to rank 0
    (`gather_to_lead`), which alone writes files.

The JAX mesh's reserved 'model' axis is not ported: no JAX code shards
over it.

Backends: NCCL where every rank holds a GPU of its own, gloo on the CPU and
where ranks share a GPU (NCCL refuses two ranks on one device). gloo
reduces and broadcasts CUDA tensors but gathers only host ones, so the
gathers here stage through the host under gloo. Host objects travel in the
default group, whatever its backend.

Ranks compute on the GPU unless the caller names the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import random
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a collective may wait before the process group gives up
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in a data-parallel world: its rank, the world's
    size, the device it computes on and the backend."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_lead(self) -> bool:
        """Rank 0, which gathers results and alone writes files."""
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n items."""
        if n % self.size:
            raise ValueError(f"{n} items do not split evenly over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def _cuda_index(d: torch.device) -> int:
    return d.index if d.index is not None else 0


def backend_for(devices: Sequence) -> str:
    """NCCL when every rank holds a GPU of its own, else gloo (the CPU, or
    ranks sharing a GPU)."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {sorted(kinds)}: all on CUDA or all on the CPU")
    idx = [_cuda_index(d) for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def _gpu(index: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no GPU is visible: name the CPU (device 'cpu') to run ranks there")
    return torch.device("cuda", index % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[DataMesh]:
    """Join a world of `num_processes` ranks as rank `process_id`, through
    the rendezvous at `coordinator` ('host:port' over TCP, or a URL:
    'tcp://', 'file://', 'env://'), computing on `device` (default: the
    GPU `cuda:LOCAL_RANK`; the CPU only when named); returns this rank's
    DataMesh. A no-op returning None at one process without a coordinator,
    as in JAX. `backend` is the world's choice that `launch` passes each
    rank; it defaults to `backend_for(device)`."""
    if coordinator is None and (num_processes or 1) == 1:
        return None
    n = num_processes or 1
    if coordinator is None:
        raise ValueError(f"a world of {n} processes needs a coordinator (host:port)")
    if process_id is None or not 0 <= process_id < n:
        raise ValueError(f"process_id {process_id} is not in [0, {n})")
    dev = _gpu(int(os.environ.get("LOCAL_RANK", 0))) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for([dev])
    timeout = datetime.timedelta(seconds=timeout_s)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=n, rank=process_id,
                            timeout=timeout)
    return DataMesh(dist.get_rank(), dist.get_world_size(), dev, backend)


def data_parallel_size(batch_size: int, avail: int) -> int:
    """The largest rank count up to `avail` that divides the global batch
    (`train_main.py:146-147`: the batch splits evenly)."""
    return max(d for d in range(1, max(avail, 1) + 1) if batch_size % d == 0)


def shard_batch(batch: Dict[str, Any], mesh: Optional[DataMesh]) -> Dict[str, Any]:
    """This rank's block of axis 0 of every array of a global batch."""
    if mesh is None:
        return batch
    return {k: v[mesh.block(len(v))] for k, v in batch.items()}


def all_reduce_with_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, differentiable: the gradient of each
    rank's input is the sum of the ranks' output gradients, so a loss that
    reads the global sum sends every rank its share
    (`torch.distributed.nn.functional.all_reduce`, whose deprecation
    warning is silenced here)."""
    import warnings

    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t)


def reduce_mean(values: Dict[str, torch.Tensor], mesh: Optional[DataMesh]
                ) -> Dict[str, torch.Tensor]:
    """Each 0-dim value averaged over the ranks, in one all_reduce: the
    global-batch value of a mean over equal blocks."""
    if mesh is None or not values:
        return values
    flat = torch.stack([torch.as_tensor(v).detach().float().reshape(()).to(mesh.device)
                        for v in values.values()])
    dist.all_reduce(flat)
    return dict(zip(values, flat.div_(mesh.size).unbind()))


def average_gradients(params, mesh: Optional[DataMesh]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in one
    flattened all_reduce. Every rank must hold gradients on the same
    parameters (the same model and loss)."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(mesh.size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_module(module: torch.nn.Module, mesh: Optional[DataMesh]) -> None:
    """Every parameter and buffer of `module` set to rank 0's."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)


def barrier(mesh: Optional[DataMesh]) -> None:
    if mesh is not None:
        dist.barrier(device_ids=[mesh.device.index] if mesh.backend == "nccl" else None)


def gather_to_lead(obj: Any, mesh: Optional[DataMesh]) -> Optional[List[Any]]:
    """Every rank's picklable `obj` (numpy records of any length), in rank
    order, on rank 0; None on the other ranks. Without a mesh: [obj]."""
    if mesh is None:
        return [obj]
    out = [None] * mesh.size if mesh.is_lead else None
    dist.gather_object(obj, out, dst=0)
    return out


def all_gather_rows(t: Optional[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Every rank's tensor, in rank order, on every rank's device. The
    tensors share their trailing shape and dtype and may differ in their
    first dimension; a rank with nothing passes None. Moves bytes only, so
    what arrives is bit-identical to what was sent."""
    meta = [None] * mesh.size
    dist.all_gather_object(meta, None if t is None else (tuple(t.shape), t.dtype))
    known = [m for m in meta if m is not None]
    if not known:
        return []
    rest, dtype = known[0][0][1:], known[0][1]
    rows = [m[0][0] if m is not None else 0 for m in meta]
    comm = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    pad = torch.zeros((max(rows), *rest), dtype=dtype, device=comm)
    if t is not None:
        pad[:t.shape[0]] = t.to(comm)
    bufs = [torch.empty_like(pad) for _ in range(mesh.size)]
    dist.all_gather(bufs, pad)
    return [b[:r].to(mesh.device) for b, r in zip(bufs, rows)]


# set in a launched rank's environment: a rank launches no world of its own
_RANK_ENV = "V2CE_LAUNCHED_RANK"


class RankFailure(RuntimeError):
    """A rank of a launched world failed, exited without its result or
    outlived its time limit; every rank was stopped."""


def _rank_entry(rank, world, fn, args, devices, backend, url, timeout_s, threads, results):
    torch.set_num_threads(threads)
    mesh = init_distributed(url, world, rank, backend=backend, device=devices[rank],
                            timeout_s=timeout_s)
    results.put((rank, pickle.dumps(fn(mesh, *args))))
    # only here: a rank that raises reports its error before its exit
    # breaks its peers' collectives, so its error is the one reported
    dist.destroy_process_group()


def launch(fn: Callable, world_size: int, *, args: tuple = (), devices: Optional[Sequence] = None,
           timeout_s: Optional[float] = None,
           collective_timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run `fn(mesh, *args)` in `world_size` processes started with the
    'spawn' method, rank r on `devices[r]` (default: `cuda:r`, modulo the
    visible GPUs; the CPU only when named), over `backend_for(devices)`;
    returns each rank's return value, in rank order. `fn` and `args` are
    pickled: `fn` must be importable by name, and a rank imports the
    caller's main module afresh (the 'spawn' method), so that module must
    launch only under `if __name__ == "__main__":` (a rank that launches
    raises).

    Before the first rank starts, the CUDA kernels are built here once
    (each rank loads that library). Every rank gets this process's
    PYTHONHASHSEED (one drawn for the world where it is unset: str hashes
    seed the datasets' augmentation) and its share of this process's torch
    threads. If a rank raises, exits without its result or the world
    outlives `timeout_s`, every rank is stopped and RankFailure is raised
    (`torch.multiprocessing.start_processes` supervises the ranks)."""
    import torch.multiprocessing as tmp

    if _RANK_ENV in os.environ:
        raise RuntimeError("launch inside a launched rank: the rank re-ran a module that "
                           "launches when imported (guard it with `if __name__ == "
                           "'__main__':`)")
    devices = [torch.device(d) for d in (devices or [_gpu(r) for r in range(world_size)])]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    backend = backend_for(devices)
    if any(d.type == "cuda" for d in devices):
        from v2ce_toolbox_tpu_torch.ops import _cuda

        _cuda.build()
    results = tmp.get_context("spawn").SimpleQueue()     # pickled bytes, no shared tensors
    rendezvous = tempfile.mkdtemp(prefix="v2ce_rendezvous_")
    url = "file://" + os.path.join(rendezvous, "store")
    threads = max(1, torch.get_num_threads() // world_size)
    hashseed = os.environ.get("PYTHONHASHSEED") or str(random.randrange(1, 2 ** 32))
    env = {"PYTHONHASHSEED": hashseed, _RANK_ENV: "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)                  # what the spawned ranks start with
    try:
        ctx = tmp.start_processes(
            _rank_entry, nprocs=world_size, join=False, start_method="spawn",
            args=(world_size, fn, args, devices, backend, url, collective_timeout_s, threads,
                  results))
    except BaseException:
        shutil.rmtree(rendezvous, ignore_errors=True)
        raise
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: Dict[int, Any] = {}

    def drain():                            # a rank's put blocks until it is read
        while not results.empty():
            rank, payload = results.get()
            out[rank] = pickle.loads(payload)

    try:
        while not ctx.join(timeout=0.5):
            drain()
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailure(f"the world of {world_size} ranks outlived {timeout_s} s")
        drain()
    except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
        raise RankFailure(str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
    missing = sorted(set(range(world_size)) - set(out))
    if missing:
        raise RankFailure(f"ranks {missing} exited without their result")
    return [out[r] for r in range(world_size)]
