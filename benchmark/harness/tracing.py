"""The traced run's instruments, all registered from the benchmark around
calls into the program's layers (no span lives inside the program):

- :class:`Marks`: CUDA events recorded at named points of every request
  or step (its start and end, and module and optimizer hooks between);
- :func:`scopes`: a ``record_function`` range around every forward of the
  modules of one class name, so that the profiler's kernels can be
  attributed to the layer whose forward launched them;
- :func:`read_trace`: device busy time, idle gaps, the top device
  operations and the device time inside those ranges, from the chrome
  trace of a ``torch.profiler`` stretch.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Marks:
    """One dict of named CUDA events per request or step (nothing is
    recorded unless ``enabled``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.rows = []

    def begin(self):
        self.rows.append({})

    def mark(self, name: str):
        if self.enabled and self.rows:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.rows[-1][name] = ev

    def spans(self, a: str, b: str) -> list:
        """ms from mark ``a`` to mark ``b`` in every row that holds both."""
        torch.cuda.synchronize()
        return [r[a].elapsed_time(r[b]) for r in self.rows if a in r and b in r]


def module_marks(marks: Marks, module: torch.nn.Module, before: str, after: str) -> list:
    """Hooks that mark ``before`` as ``module``'s forward starts and
    ``after`` as it returns; returns their handles."""
    return [module.register_forward_pre_hook(lambda *_: marks.mark(before)),
            module.register_forward_hook(lambda *_: marks.mark(after))]


def optimizer_marks(marks: Marks, optimizer: torch.optim.Optimizer, before: str, after: str) -> list:
    return [optimizer.register_step_pre_hook(lambda *_: marks.mark(before)),
            optimizer.register_step_post_hook(lambda *_: marks.mark(after))]


@contextlib.contextmanager
def scopes(model: torch.nn.Module, class_name: str, label: str):
    """A ``record_function(label)`` range around every forward of the
    submodules named ``class_name``."""
    handles, stack = [], []

    def enter(*_):
        rf = torch.autograd.profiler.record_function(label)
        rf.__enter__()
        stack.append(rf)

    def leave(*_):
        stack.pop().__exit__(None, None, None)

    for m in model.modules():
        if type(m).__name__ == class_name:
            handles += [m.register_forward_pre_hook(enter), m.register_forward_hook(lambda *a: leave())]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(device: list, lo: float, hi: float):
    """(busy time, idle gaps as (start, end)) of device intervals clipped
    to [lo, hi]; the interval union, so overlapping operations count once."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in device if e > lo and s < hi]
    merged = _union(clipped)
    busy = sum(e - s for s, e in merged)
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def _inside(ranges: list, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, [t, float("inf")]) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def _host_label(cpu_ops: list, starts: list, long_ops: list, t: float) -> str:
    """The innermost host operation running at time ``t``: among the few
    hundred that started last before it, else among the long ones."""
    best = None
    lo = bisect.bisect_right(starts, t) - 1
    for s, e, name in cpu_ops[max(0, lo - 500): lo + 1] + long_ops:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "host (no operation)"


def read_trace(path: str, window: str, scope_labels=(), backward: bool = False) -> dict:
    """Readings of a chrome trace written by ``torch.profiler``: the
    window is the ``record_function(window)`` range; device intervals are
    its kernels, copies and sets; a device operation belongs to a scope
    when the host call that launched it (same correlation id) ran inside a
    ``record_function`` range of that label, on the same thread; with
    ``backward``, also when it ran inside the backward of an operation
    that ran in such a range (the autograd node whose sequence number the
    forward operation carries)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy_us, gaps = busy_and_gaps([(e["ts"], e["ts"] + e["dur"]) for e in device], lo, hi)

    by_name = collections.Counter()
    for e in device:
        by_name[e["name"][:160]] += e["dur"] * 1e-6
    cpu_ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"][:160]) for e in xs
                     if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
                     and e["name"] != window)
    starts = [c[0] for c in cpu_ops]
    long_ops = [c for c in cpu_ops if c[1] - c[0] >= 1000.0]
    idle_by_host = collections.Counter()
    for s, e in gaps:
        idle_by_host[_host_label(cpu_ops, starts, long_ops, (s + e) / 2)] += (e - s) * 1e-6

    scoped = {}
    launch = {e["args"]["correlation"]: (e["ts"], e.get("tid")) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    for label in scope_labels:
        ranges = collections.defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and e["name"] == label:
                ranges[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
        for tid in ranges:
            ranges[tid] = _union(ranges[tid])
        if backward:
            seqs = set()
            for e in xs:
                seq = e.get("args", {}).get("Sequence number")
                if e.get("cat") == "cpu_op" and seq is not None and _inside(ranges.get(e.get("tid"), []), e["ts"]):
                    seqs.add(seq)
            for e in xs:
                if (e.get("cat") == "cpu_op" and e["name"].startswith("autograd::engine::evaluate_function")
                        and e.get("args", {}).get("Sequence number") in seqs):
                    ranges[e.get("tid")].append([e["ts"], e["ts"] + e["dur"]])
            for tid in ranges:
                ranges[tid] = _union(ranges[tid])
        total = 0.0
        for e in device:
            at = launch.get(e.get("args", {}).get("correlation"))
            if at is None:
                continue
            if _inside(ranges.get(at[1], []), at[0]):
                total += e["dur"]
        scoped[label] = total * 1e-3  # ms
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in idle_by_host.most_common(10)],
        "scoped_ms": scoped,
        "device_ops_n": len(device),
    }
