"""Profiling utilities: device-synchronised timing, torch.profiler traces,
and the package's own spans and counters (counterpart of
cofii2p_tpu/utils/profiling.py, plus the spans).

- :func:`timeit_sync` measures the steady-state time of a call: on the
  card between CUDA events recorded around the timed calls, after a
  ``torch.cuda.synchronize`` that drains the warm-up; on the CPU with the
  host clock.
- :func:`span` marks a stretch of the program by name.  Off (no torch
  profiler running and no :func:`recording` block open) it costs one check
  and returns a shared null context.  On, it opens a ``record_function``
  range of its name, so a profiler's trace shows it on the device trace's
  clock, and adds to a registry, by name: the entry count, the host time
  (``time.perf_counter_ns``) and the device time of the current stream
  between two timing CUDA events, which :func:`span_table` resolves.  A
  span entered while its stream is being captured into a CUDA graph
  records no events.
- :func:`counter` counts an event (a graph capture, a build, the path a
  point-branch group norm or a window placement took); counters are always
  on.
- :func:`span_table` tabulates the registry, :func:`reset` clears it, and
  ``SPAN_NAMES`` lists every span and counter the package records.
- :func:`trace` wraps ``torch.profiler`` (CPU activity, and CUDA activity
  where a card is present) and writes a Chrome trace of what runs inside,
  and the span table beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable

import torch

# every span and counter name the package records; "<i>" stands for a
# transformer layer's index, "<stage>" for a serving graph's stage
# (utils/cuda_graphs.py: prep, pc_encoder, network, fine_match)
SPAN_NAMES = (
    "cofii2p.eval",
    "cofii2p.prep",
    "cofii2p.network",
    "cofii2p.pc_encoder",
    "cofii2p.img_encoder",
    "cofii2p.transformer",
    "cofii2p.transformer.<i>.self",
    "cofii2p.transformer.<i>.cross",
    "cofii2p.selection",
    "cofii2p.fine_match",
    "cofii2p.ransac",
    "cofii2p.ransac.replay",
    "cofii2p.ransac.graph_nodes",
    "cofii2p.ransac.captures",
    "cofii2p.graph.<stage>",
    "cofii2p.graph.<stage>.replay",
    "cofii2p.graph.<stage>.graph_nodes",
    "cofii2p.graph.<stage>.captures",
    "cofii2p.train_step",
    "cofii2p.train.losses",
    "cofii2p.train.backward",
    "cofii2p.train.grad_norm",
    "cofii2p.train.optimizer",
    "cofii2p.loader.wait",
    "cofii2p.point_norm.fused",
    "cofii2p.point_norm.plain",
    "cofii2p.windows.kernel",
    "cofii2p.windows.plain",
)


class _Null:
    """The span while spans are off: a context that does nothing (cheaper
    to enter than ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_profiler_on = torch._C._autograd._profiler_enabled
_NULL = _Null()
_lock = threading.Lock()
_recording = 0
_spans: dict = {}
_counters: dict = {}
# a span's event pairs, past which those the stream has passed are resolved
# on exit: under a long profiler no table is read to drain them
_PENDING_MAX = 1024


class _Record:
    __slots__ = ("n", "host_ns", "device_ms", "pending")

    def __init__(self):
        self.n, self.host_ns, self.device_ms, self.pending = 0, 0, None, []


class _Span:
    __slots__ = ("name", "range", "rec", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        with _lock:  # made on entry, so the table lists spans in the order they open
            self.rec = _spans.get(self.name)
            if self.rec is None:
                self.rec = _spans[self.name] = _Record()
        self.range = torch.autograd.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        with _lock:
            self.rec.n += 1
            self.rec.host_ns += host_ns
            if end is not None:
                self.rec.pending.append((self.start, end))
                if len(self.rec.pending) >= _PENDING_MAX:
                    _resolve(self.rec, wait=False)
        self.range.__exit__(*exc)
        return False


def _resolve(rec: _Record, wait: bool) -> None:
    """Adds the elapsed time of ``rec``'s pending event pairs to its
    device ms: every pair (``wait``: after waiting for each), or only
    the leading pairs the stream has passed, with no wait."""
    done = 0
    for start, end in rec.pending:
        if wait:
            end.synchronize()
        elif not end.query():
            break
        rec.device_ms = (rec.device_ms or 0.0) + start.elapsed_time(end)
        done += 1
    del rec.pending[:done]


def span(name: str):
    """A context manager that records the block as the span ``name``
    while a torch profiler runs or a :func:`recording` block is open, and
    does nothing otherwise."""
    if not (_recording or _profiler_on()):
        return _NULL
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record spans inside the block with no profiler running."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class Counter:
    """A count in the registry: ``add(n)`` for events, ``set(v)`` for a
    reading such as a graph's size."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n: int = 1) -> None:
        with _lock:
            self.value += n

    def set(self, v: int) -> None:
        self.value = v


def counter(name: str) -> Counter:
    """The registry's counter ``name`` (made at 0 on first use)."""
    with _lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter()
        return c


def span_table() -> dict:
    """``{span: {"n", "host_ms", "device_ms"}}`` and ``{counter: {"value"}}``
    over the registry; ``device_ms`` is None for a span that recorded no
    events.  Waits for the events still pending."""
    with _lock:
        table = {}
        for name, rec in _spans.items():
            _resolve(rec, wait=True)
            table[name] = {"n": rec.n, "host_ms": rec.host_ns * 1e-6, "device_ms": rec.device_ms}
        table.update({name: {"value": c.value} for name, c in _counters.items()})
    return table


def reset(counters: bool = True) -> None:
    """Clear every span's record and, unless ``counters`` is false, every
    counter."""
    with _lock:
        _spans.clear()
        if counters:
            _counters.clear()


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
    format) and ``<log_dir>/spans.json`` (:func:`span_table` of the spans
    the block recorded, those before it cleared on entry, and the
    counters): ``with trace('chiprun_out/trace'): step()``.  Yields the
    profiler, whose ``key_averages()`` tabulates the ops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset(counters=False)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump(span_table(), fh, indent=1, sort_keys=True)
