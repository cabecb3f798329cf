"""Runtime utilities: logging, timers, the experiment working tree,
device traces and debug checks.

The JAX package's `utils/runtime.py` in torch: `device_trace` records the
card with `torch.profiler` (CPU and CUDA activity) and writes a Chrome
trace; `enable_debug_checks` turns on autograd's anomaly detection, and while it
is on every train step checks its logs (`check_finite`), raising
FloatingPointError as jax_debug_nans does.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import os.path as op
import time
from typing import Mapping, Optional


def init_logging(log_dir: Optional[str] = None, level: str = "INFO",
                 filename: str = "log.txt"):
    """stdout, plus `log_dir/filename` when a directory is given."""
    handlers = [logging.StreamHandler()]
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(op.join(log_dir, filename)))
    logging.basicConfig(
        level=getattr(logging, level.upper()),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def build_working_tree(root: str, exp_name: Optional[str] = None) -> dict:
    """Create the per-experiment directories (logs, checkpoints, recorder,
    profile) under root/exp_name, the name defaulting to a timestamp kept
    in RUN_TIMESTAMP so that the processes of one launch share a tree."""
    ts = os.environ.setdefault("RUN_TIMESTAMP", time.strftime("%Y%m%d-%H%M%S"))
    base = op.join(root, exp_name or ts)
    tree = {
        "base": base,
        "logs": op.join(base, "logs"),
        "checkpoints": op.join(base, "checkpoints"),
        "recorder": op.join(base, "recorder"),
        "profile": op.join(base, "profile"),
    }
    if int(os.environ.get("LOCAL_RANK", 0)) == 0:
        for p in tree.values():
            os.makedirs(p, exist_ok=True)
    return tree


class Timer:
    """Context-manager wall-clock timer; logs and keeps `elapsed` (s)."""

    def __init__(self, name: str = "timer", logger=None):
        self.name = name
        self.logger = logger or logging.getLogger(__name__)

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.start
        self.logger.info("%s took %.4fs", self.name, self.elapsed)


def tic_toc(fn):
    """Decorator logging each call's wall time."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        logging.getLogger(fn.__module__).info("%s took %.4fs", fn.__name__, time.time() - t0)
        return out

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where the card is
    there); writes `log_dir/trace.json` (Chrome trace format) and yields
    the profiler, whose `key_averages()` lists the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(op.join(log_dir, "trace.json"))


def enable_debug_checks(nans: bool = True):
    """Debug mode on (or off): autograd's anomaly detection, which names
    the op whose backward made a NaN, and the train step's finite check
    of its logs."""
    import torch

    torch.autograd.set_detect_anomaly(nans, check_nan=nans)


def debug_checks_enabled() -> bool:
    import torch

    return torch.is_anomaly_enabled()


def check_finite(logs: Mapping) -> None:
    """Raise FloatingPointError naming the terms that are NaN or inf."""
    bad = {k: float(v) for k, v in logs.items() if not math.isfinite(float(v))}
    if bad:
        raise FloatingPointError(f"non-finite training terms: {bad}")
