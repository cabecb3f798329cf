"""Host-side batching with background workers and device prefetch.

Replaces torch DataLoader + Lightning DataInterface
(reference: train/scripts/data/data_interface.py:32-39): a thread pool
materializes packets ahead of consumption, and batches are copied to the
card from pinned host memory one step ahead of compute, double-buffering
host IO against device execution. `iterate_batches` is
`v2ce_toolbox_tpu/data/loader.py`'s; under a data-parallel mesh
(`parallel/mesh.py`) every rank walks the same global order and collates
only its own block of each global batch (the JAX mesh's `P("data")`).
`device_prefetch` takes the rank's device where the JAX version took a
mesh.
"""

from __future__ import annotations

import concurrent.futures
from typing import Dict, Iterator

import numpy as np
import torch


def iterate_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 4,
    drop_last: bool = True,
    mesh=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked host batches from an indexable dataset; under a
    `mesh`, this rank's block of each global batch of `batch_size` items
    (the batches are whole: drop_last, and batch_size divisible by the
    rank count)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if drop_last or mesh is not None:
        order = order[: (n // batch_size) * batch_size]

    def collate(indices):
        items = [dataset[int(i)] for i in indices]
        return {k: np.stack([it[k] for it in items], axis=0)
                for k in items[0]}

    block = slice(None) if mesh is None else mesh.block(batch_size)
    chunks = [order[i:i + batch_size][block] for i in range(0, len(order), batch_size)]
    if num_workers <= 1:
        for c in chunks:
            yield collate(c)
        return

    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        futures = []
        # keep up to num_workers batches in flight
        it = iter(chunks)
        for _ in range(num_workers):
            c = next(it, None)
            if c is not None:
                futures.append(pool.submit(collate, c))
        while futures:
            batch = futures.pop(0).result()
            c = next(it, None)
            if c is not None:
                futures.append(pool.submit(collate, c))
            yield batch


def device_prefetch(host_batches, device="cuda", depth: int = 2):
    """Move batches of numpy arrays to `device` ahead of consumption: each
    array becomes a tensor, pinned and copied with non_blocking=True on a
    CUDA device, so up to `depth` copies are in flight while the consumer
    computes. Yields dicts of tensors on the device."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if cuda:
                t = t.pin_memory()
            out[k] = t.to(dev, non_blocking=cuda)
        return out

    queue = []
    for batch in host_batches:
        queue.append(put(batch))
        if len(queue) >= depth:
            yield queue.pop(0)
    while queue:
        yield queue.pop(0)
