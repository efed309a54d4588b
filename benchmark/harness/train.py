"""A training cell: back-to-back optimizer steps of the program's
``train_lib.make_train_step`` on batches from a pool of distinct frames,
fresh draws every step.  Set-up builds the one model, optimizer and step
and drives its first three steps through the window's own call and feed;
those three are then recomputed by the plain reference and judged:

- ``loss``: the largest relative gap of a step's total loss;
- ``grad``: the first step's gradient as Adam holds it (its first moment
  over 1 - b1), by the worst leaf: the gap between the program's and the
  reference's norms of a leaf over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change``: the parameters' change over the three steps, by the worst
  leaf, in the same measure.

Leaves whose reference gradient is under a thousandth of the median
leaf's (biases that a norm subtracts again) move under Adam by round-off
alone: they are left out of ``grad`` and ``change`` by that rule.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import frames, stats, tracing, weights, work
from benchmark.harness.serve import GIB, program_config, reference_config, set_precision

FIRST = 3  # steps the reference follows
B1 = 0.9


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """Each leaf's |norm gap| over max(its reference norm, the median
    leaf's); a leaf the program's optimizer holds no state for reads as
    norm 0."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keep}


def kept(grad_ref: dict) -> list:
    med = float(np.median(list(grad_ref.values())))
    return [k for k, v in grad_ref.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict, log=None) -> dict:
    keep = kept(ref["grad"])
    out = {"loss": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    for k in ("grad", "change"):
        gaps = leaf_gaps(prog[k], ref[k], keep)
        worst = max(gaps, key=gaps.get)
        out[k] = gaps[worst]
        if log is not None:
            log(f"{k}: worst leaf {worst} ({gaps[worst]!r}), median leaf gap {float(np.median(list(gaps.values())))!r}")
    return out


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def reference_first_steps(conf, traffic, seed, device, pool_host, order, fmt=None) -> dict:
    """The reference's first three steps on the same batches, weights and
    draws; with ``fmt``, computed in that lower precision (control.py)."""
    from benchmark.harness.control import Rounded
    from benchmark.reference.models.network import CoFiI2P
    from benchmark.reference import train as rtrain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg = reference_config(conf, "train")
    with torch.device(device):
        model = CoFiI2P(rcfg)
    jitter = conf["paths"]["train"]["jitter_kernel_points"]
    model.load_state_dict(weights.seeded_state(model, seed, device, jitter))
    model.train()
    opt = rtrain.make_optimizer(rcfg, model.parameters())
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = {"loss": []}
    for i in range(FIRST):
        hb = {k: v.to(device) for k, v in pool_host[int(order[i])].items()}
        draws = frames.train_draws(rcfg, traffic["batch"], seed, i, device)
        opt.zero_grad(set_to_none=True)
        with Rounded(fmt) if fmt else contextlib.nullcontext():
            with torch.no_grad():
                batch = rtrain.prepare_batch(rcfg, hb, draws)
            terms = rtrain.loss_fn(rcfg, model, batch)
        terms["loss"].backward()
        out["loss"].append(terms["loss"].item())
        if i == 0:
            out["grad"] = _norms({k: p.grad for k, p in model.named_parameters() if p.grad is not None})
        opt.step()
        del batch, terms
    out["change"] = _norms({k: p - p0[k] for k, p in model.named_parameters()})
    del model, opt, p0
    gc.collect()
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    return out


def run(conf: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_start: float, device,
        log=print, fault=None) -> dict:
    """One run of a training cell.  ``fault`` (tests and readings only)
    takes (model, optimizer, train_step) and returns a broken step."""
    from cofii2p_tpu_torch import train_lib
    from cofii2p_tpu_torch.models.network import CoFiI2P

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kind_conf = conf["paths"]["train"]
    cfg = program_config(conf, "train")
    set_precision(kind_conf["precision"], device)
    with torch.device(device):
        model = CoFiI2P(cfg)
    model.load_state_dict(weights.seeded_state(model, seed, device, kind_conf["jitter_kernel_points"]))
    model.train()
    optimizer = train_lib.make_optimizer(cfg, model.parameters())
    step = train_lib.make_train_step(cfg, model, optimizer)
    if fault is not None:
        step = fault(model, optimizer, step)
    b = traffic["batch"]
    pool_host = frames.pool(cfg, seed, traffic["pool_batches"], b, pin=on_card)
    order = frames.order(seed, traffic["pool_batches"], 1 << 20)
    marks = tracing.Marks(enabled=trace)

    def one(i: int):
        marks.begin()
        marks.mark("start")
        dev = {k: v.to(device, non_blocking=True) for k, v in pool_host[int(order[i])].items()}
        metrics = step(dev, frames.train_draws(cfg, b, seed, i, device))
        marks.mark("end")
        return metrics

    # set-up: the first steps, through the window's own call and feed
    params = dict(model.named_parameters())
    losses = []
    for i in range(FIRST):
        losses.append(one(i)["loss"])
        if i == 0:
            first = _norms({k: optimizer.state[p]["exp_avg"] / (1 - B1) for k, p in params.items()
                            if p in optimizer.state})
    p0 = weights.seeded_state(model, seed, device, kind_conf["jitter_kernel_points"])
    prog = {"loss": [float(x) for x in losses], "grad": first,
            "change": _norms({k: p - p0[k] for k, p in params.items()})}
    del p0
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up done in {setup_s:.3f} s")

    handles = []
    if trace:
        handles = (tracing.module_marks(marks, model, "net_start", "net_end")
                   + tracing.optimizer_marks(marks, optimizer, "opt_start", "opt_end"))
    marks.rows.clear()
    n_prof = traffic["profile_steps"] if trace else 0
    tmp = tempfile.TemporaryDirectory(prefix="bench_trace_") if trace else None
    prof = None
    i = FIRST
    # Python's garbage collector is held off in the window
    gc.collect()
    gc.freeze()
    gc.disable()
    t0 = time.perf_counter()
    while True:
        if i == FIRST and n_prof:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            scope_ctx = tracing.scopes(model, "KPConv", "bench.kpconv")
            scope_ctx.__enter__()
            win = torch.autograd.profiler.record_function("bench.window")
            win.__enter__()
        if time.perf_counter() - t0 >= seconds and i - FIRST >= n_prof:
            break
        one(i)
        i += 1
        if i - FIRST == n_prof:
            torch.cuda.synchronize()
            win.__exit__(None, None, None)
            scope_ctx.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            t_after = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.enable()
    gc.unfreeze()
    for h in handles:
        h.remove()
    n = i - FIRST
    log(f"window: {n} steps of {b} frames in {window_s:.4f} s")

    result = {"attempted": n, "metrics": {}, "peak": peak, "setup_s": setup_s}
    if not trace:
        result["metrics"] = {
            "train_frames_per_s": {"value": stats.rate(n * b, window_s), "unit": "frames/s"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        n_traced = n - n_prof
        spans = {
            "prep": marks.spans("start", "net_start")[n_prof:],
            "forward": marks.spans("net_start", "net_end")[n_prof:],
            "backward": marks.spans("net_end", "opt_start")[n_prof:],
            "optimizer": marks.spans("opt_start", "opt_end")[n_prof:],
            "step": marks.spans("start", "end")[n_prof:],
        }
        path = os.path.join(tmp.name, "trace.json")
        t_x = time.perf_counter()
        prof.export_chrome_trace(path)
        log(f"trace of {n_prof} steps: {os.path.getsize(path) / 2**20:.1f} MiB written in "
            f"{time.perf_counter() - t_x:.3f} s")
        t_x = time.perf_counter()
        readings = tracing.read_trace(path, "bench.window", ["bench.kpconv"], backward=True)
        log(f"trace read in {time.perf_counter() - t_x:.3f} s: {readings.get('device_ops_n')} device operations, "
            f"{readings.get('scoped_ms')} ms in KPConv layers")
        del prof
        tmp.cleanup()
        result["trace"] = {"kind": "train", "spans": spans, "readings": readings,
                           "traced_s": window_s - (t_after - t0),
                           "traced_steps": n_traced, "profiled_steps": n_prof}

    del model, optimizer, step, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        result["trace"]["work"] = first_batch_work(conf, traffic, seed, device, pool_host, order)
        log(f"work of a step: {result['trace']['work']}")
        result["trace"]["peak_flops"] = work.PEAK_FLOPS[kind_conf["precision"]]
    t_x = time.perf_counter()
    ref = reference_first_steps(conf, traffic, seed, device, pool_host, order)
    log(f"reference steps in {time.perf_counter() - t_x:.3f} s")
    numbers = train_numbers(prog, ref, log)
    result["numbers"] = numbers
    result["rows"] = [numbers]
    log(f"first steps: program losses {prog['loss']}, reference losses {ref['loss']}")
    return result


def first_batch_work(conf, traffic, seed, device, pool_host, order) -> dict:
    """A step's model FLOPs (three times the train-mode forward's, by
    work.py) and its KPConv layers' least time, forward and backward, on
    the first step's batch and draws."""
    from benchmark.reference import train as rtrain
    from benchmark.reference.models.network import CoFiI2P

    rcfg = reference_config(conf, "train")
    with torch.device(device):
        model = CoFiI2P(rcfg)
    model.load_state_dict(weights.seeded_state(model, seed, device, conf["paths"]["train"]["jitter_kernel_points"]))
    counter = work.Counter(conf["paths"]["train"]["precision"], rcfg.attention)
    hb = {k: v.to(device) for k, v in pool_host[int(order[0])].items()}
    draws = frames.train_draws(rcfg, traffic["batch"], seed, 0, device)

    def forward():
        with torch.no_grad():
            model(rtrain.prepare_batch(rcfg, hb, draws), mode="train", train=True)

    flops, _, kp_train_ms = counter.count(forward)
    del model
    return {"flops": 3.0 * flops, "kpconv_bound_ms": kp_train_ms}


def control_numbers(conf: dict, traffic: dict, seed: int, device, fmt: str) -> dict:
    """The judged numbers with the lower-precision reference's first
    steps in the program's place."""
    cfg = program_config(conf, "train")
    pool_host = frames.pool(cfg, seed, traffic["pool_batches"], traffic["batch"], pin=False)
    order = frames.order(seed, traffic["pool_batches"], FIRST)
    ref = reference_first_steps(conf, traffic, seed, device, pool_host, order)
    low = reference_first_steps(conf, traffic, seed, device, pool_host, order, fmt=fmt)
    return train_numbers(low, ref)
