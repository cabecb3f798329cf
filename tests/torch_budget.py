"""The CPU that a module of the port's CPU tests takes in a tier-1 run
(`pytest -n 6 --dist load` on an 8-core host), set for the module's tests
and restored after them:

  * torch on one or two threads: every worker's OpenMP pool would claim all
    the cores, and the oversubscribed pools spin;
  * the worker's threads (its own, JAX's and torch's) at the lowest
    scheduling priority: the JAX package's long tests
    (`tests/test_pipeline.py`'s end-to-end and multi-device runs, queued on
    one worker) set the run's end, and the port's tests, about a third of
    the run's CPU time beside them, then take only the cores those leave
    idle. A thread that cannot raise its priority again without the
    privilege keeps the lower one.
"""

import contextlib
import os

import torch


def _threads():
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except OSError:                      # no procfs: the calling thread alone
        return [0]


def _priorities():
    out = {}
    for t in _threads():
        try:
            out[t] = os.getpriority(os.PRIO_PROCESS, t)
        except ProcessLookupError:       # the thread has ended
            pass
    return out


def _set_priority(tid, prio):
    try:
        os.setpriority(os.PRIO_PROCESS, tid, prio)
    except (PermissionError, ProcessLookupError):
        pass


@contextlib.contextmanager
def cpu_budget(threads):
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    prios = _priorities()
    for t in prios:
        _set_priority(t, 19)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        for t, p in prios.items():
            _set_priority(t, p)
