"""Checkpoints of the whole training state, with `torch.save`.

A checkpoint is one file holding the generator's state_dict (parameters,
BN statistics, spectral-norm vectors), the discriminator's, both
optimizers' (Adam moments and counts) and the step. The names are the
JAX package's: `<ckpt_dir>/best-epoch=N` and `<ckpt_dir>/last`, which
`best_or_last` resolves in the same order.
"""

from __future__ import annotations

import os
import os.path as op
import re
from typing import Any, Optional

import torch

from v2ce_toolbox_tpu_torch.parallel.mesh import barrier
from v2ce_toolbox_tpu_torch.train.state import TrainState


def save_checkpoint(path: str, state, mesh=None) -> None:
    """Write a TrainState (or any picklable tree of tensors) to `path`,
    through a temporary file, so a crash leaves the old one whole. Under a
    data-parallel `mesh` (every rank holding the same state) rank 0 alone
    writes, and every rank returns once the file is whole."""
    from v2ce_toolbox_tpu_torch.train.state import TrainState

    if mesh is not None and not mesh.is_lead:
        barrier(mesh)
        return

    tree = state
    if isinstance(state, TrainState):
        tree = {"step": state.step, "model": state.model.state_dict(),
                "opt": state.opt.state_dict(),
                "disc": state.disc.state_dict() if state.disc is not None else None,
                "disc_opt": state.disc_opt.state_dict() if state.disc_opt is not None else None}
    head, name = op.split(op.abspath(path))
    os.makedirs(head, exist_ok=True)
    tmp = op.join(head, f".{name}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)
    barrier(mesh)


def load_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read a checkpoint. With a TrainState `target`, load it into the
    target's modules and optimizers in place (tensors go to each module's
    device) and return the target; else return what was saved."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return tree
    target.model.load_state_dict(tree["model"])
    target.opt.load_state_dict(tree["opt"])
    if (tree["disc"] is None) != (target.disc is None):
        raise ValueError(f"{path}: the checkpoint and the run differ in having a "
                         "discriminator (--loss gan)")
    if target.disc is not None:
        target.disc.load_state_dict(tree["disc"])
        target.disc_opt.load_state_dict(tree["disc_opt"])
    target.step = int(tree["step"])
    return target


def best_or_last(ckpt_dir: str, prefer_best: bool = True) -> Optional[str]:
    """The checkpoint to resume from in a directory of `best-*` and `last`
    entries: the best of the highest epoch when `prefer_best` and one
    exists, else `last`, else None."""
    if not op.isdir(ckpt_dir):
        return None
    entries = os.listdir(ckpt_dir)
    if prefer_best:
        best = [e for e in entries if e.startswith("best-")]
        if best:
            def epoch_of(e):
                m = re.search(r"epoch=(\d+)", e)
                return int(m.group(1)) if m else -1

            return op.join(ckpt_dir, max(best, key=epoch_of))
    if "last" in entries:
        return op.join(ckpt_dir, "last")
    return None
