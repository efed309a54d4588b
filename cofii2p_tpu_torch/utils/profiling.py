"""Profiling utilities: device-synchronised timing and torch.profiler
traces (counterpart of cofii2p_tpu/utils/profiling.py).

- :func:`timeit_sync` measures the steady-state time of a call: on the
  card between CUDA events recorded around the timed calls, after a
  ``torch.cuda.synchronize`` that drains the warm-up; on the CPU with the
  host clock.
- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA activity
  where a card is present) and writes a Chrome trace of what runs inside.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _devices_of(out) -> set:
    """CUDA devices of the tensors in a (nested) output."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):  # NamedTuple results too
        return set().union(set(), *(_devices_of(x) for x in out))
    return set()


def timeit_sync(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kw) -> float:
    """Mean seconds per call of ``fn(*args, **kw)`` over ``iters`` calls
    after ``warmup`` ones.  Where the arguments or the warm-up's output hold
    CUDA tensors, the time is read from CUDA events on the current stream
    of the first such device, after a synchronize; otherwise from the host
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    devices = _devices_of([args, list(kw.values()), out])
    if devices:
        dev = sorted(devices, key=str)[0]
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        for _ in range(iters):
            fn(*args, **kw)
        end.record(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format): ``with trace('chiprun_out/trace'): step()``.  Yields the
    profiler, whose ``key_averages()`` tabulates the ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
