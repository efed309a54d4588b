"""A serving cell: one client drives the program's eval body
(cofii2p_tpu_torch/evaluation/pipeline.py::make_eval_body's ``run``) with
batches from a pool of distinct frames; each request copies its frames to
the device, draws its subsampling and RANSAC noise, runs, and copies its
poses and success flags back.  In a closed loop the next request starts
when the last one's poses are on the host; in an open loop request i is
due at i / rate seconds into the window, and its time runs from then, so
that a wait behind a slow request counts.  A traced run profiles its
first requests back to back, then starts the open loop's schedule.  A
seeded reservoir keeps the outputs of a sample of the window's requests
on the device, and only those, so that the memory the window holds does
not grow with the requests it completes; once the window has closed the
plain reference recomputes the sample and judges it.  Python's garbage
collector is held off in the window."""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import check, frames, spec, stats, tracing, weights, work

GIB = 2.0**30


def program_config(conf: dict, kind: str):
    from cofii2p_tpu_torch.config import Config

    return spec.make_config(Config, spec.path_config(conf, kind))


def reference_config(conf: dict, kind: str):
    """The reference runs the configuration's semantics in fp32, plain."""
    from benchmark.reference.config import Config

    fields = dict(spec.path_config(conf, kind), compute_dtype="float32", kpconv_kernel="xla",
                  kpconv_residual_fused=False)
    return spec.make_config(Config, fields)


def reference_model(conf: dict, kind: str, seed: int, device):
    from benchmark.reference.models.network import CoFiI2P

    rcfg = reference_config(conf, kind)
    with torch.device(device):
        model = CoFiI2P(rcfg)
    model.load_state_dict(weights.seeded_state(model, seed, device, conf["paths"][kind]["jitter_kernel_points"]))
    return rcfg, model


def set_precision(precision: str, device) -> None:
    """As the port's CLIs do: fp32 runs with TF32 off."""
    if torch.device(device).type == "cuda" and precision == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reference_numbers(conf, traffic, seed, device, pool_host, requests, outputs, fmt=None) -> list:
    """The judged numbers of each sampled request.  ``fmt`` puts the
    reference computed in that lower precision (control.py) in the
    program's place: its answers are judged as the program's would be."""
    from benchmark.harness.control import Rounded
    from benchmark.reference import pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rcfg, rmodel = reference_model(conf, "serve", seed, device)
    rmodel.eval()
    rows = []
    for req, pool_idx in requests:
        hb = {k: v.to(device) for k, v in pool_host[pool_idx].items()}
        draws = frames.serve_draws(rcfg, traffic["batch"], seed, req, device)
        ref = pipeline.serve(rcfg, rmodel, hb, draws)
        if fmt is None:
            prog = outputs[req]
        else:
            with Rounded(fmt):
                prog = pipeline.serve(rcfg, rmodel, hb, draws)
        pose_ref = pipeline.pose(rcfg, draws["gumbel"], prog["object_points"].float(), prog["fine_xy"].float(),
                                 ref["K"], prog["corr_mask"])
        rows.append(check.serve_numbers(prog, ref, pose_ref))
    del rmodel
    return rows


def run(conf: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_start: float, device,
        log=print, fault=None) -> dict:
    """One run of a serving cell; returns the result's fields.  ``fault``
    (tests only) wraps the program's ``run`` to break the timed path."""
    from cofii2p_tpu_torch.evaluation.pipeline import make_eval_body
    from cofii2p_tpu_torch.models.network import CoFiI2P

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kind_conf = conf["paths"]["serve"]
    cfg = program_config(conf, "serve")
    set_precision(kind_conf["precision"], device)
    with torch.device(device):
        model = CoFiI2P(cfg)
    model.load_state_dict(weights.seeded_state(model, seed, device, kind_conf["jitter_kernel_points"]))
    model.eval()
    body = make_eval_body(cfg, model)
    if fault is not None:
        body = fault(body)
    b = traffic["batch"]
    pool_host = frames.pool(cfg, seed, traffic["pool_batches"], b, pin=on_card)
    order = frames.order(seed, traffic["pool_batches"], 1 << 20)
    marks = tracing.Marks(enabled=trace)

    def request(i: int, pool_idx: int):
        hb = pool_host[pool_idx]
        marks.begin()
        marks.mark("start")
        dev = {k: v.to(device, non_blocking=True) for k, v in hb.items()}
        out = body(dev, draws=frames.serve_draws(cfg, b, seed, i, device))
        marks.mark("end")
        # the request ends when its poses and success flags are on the host
        torch.cat([out.R.reshape(b, 9), out.t, out.success[:, None].float()], 1).cpu()
        return out

    # warm-up: every shape of this traffic (one per pool batch, up to the
    # traffic's count), the kernel build and the RANSAC graph's capture
    for w in range(traffic["warmup_requests"]):
        request(-1 - w, w % traffic["pool_batches"])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up done in {setup_s:.3f} s")

    handles, prof_ctx = [], None
    if trace:
        handles = (tracing.module_marks(marks, model, "net_start", "net_end")
                   + tracing.module_marks(marks, model.pc_encoder, "pc_start", "pc_end"))
    marks.rows.clear()
    walls, services, pools, lates = [], [], [], []
    sample = Reservoir(traffic["check_requests"], seed)
    n_prof = traffic["profile_requests"] if trace else 0
    open_loop = traffic["loop"] == "open"
    rate = traffic.get("rate_per_s")
    tmp = tempfile.TemporaryDirectory(prefix="bench_trace_") if trace else None
    gc.collect()
    gc.freeze()
    gc.disable()
    t0 = t_open = time.perf_counter()
    i = 0
    while True:
        if i == 0 and n_prof:
            prof_ctx = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
            prof_ctx.__enter__()
            scope_ctx = tracing.scopes(model, "KPConv", "bench.kpconv")
            scope_ctx.__enter__()
            win = torch.autograd.profiler.record_function("bench.window")
            win.__enter__()
        r0 = started = time.perf_counter()
        if open_loop and i >= n_prof:
            # request i is due (i - n_prof) / rate after the schedule starts
            # (after the profiled requests, which run back to back); it
            # waits for the one before it
            due = t_open + (i - n_prof) / rate
            if due - t_open >= seconds:
                break
            if r0 < due:
                time.sleep(due - r0)
                started = time.perf_counter()
            lates.append(max(0.0, r0 - due))
            r0 = due
        elif not open_loop and r0 - t0 >= seconds and i >= n_prof:
            break
        out = request(i, int(order[i]))
        r1 = time.perf_counter()
        sample.offer(i, out)
        del out
        walls.append(r1 - r0)
        services.append(r1 - started)
        pools.append(int(order[i]))
        i += 1
        if i == n_prof:
            _sync(device)
            win.__exit__(None, None, None)
            scope_ctx.__exit__(None, None, None)
            prof_ctx.__exit__(None, None, None)
            t_after = t_open = time.perf_counter()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.enable()
    gc.unfreeze()
    for h in handles:
        h.remove()
    n = len(walls)
    log(f"window: {n} requests of {b} frames in {window_s:.4f} s; median request {np.median(walls) * 1e3:.4f} ms, "
        f"relative spread of the requests {np.std(walls) / np.mean(walls):.4f}; launches {launch_counts()}")
    if open_loop:
        log(f"open loop at {rate} requests/s: started late by {np.median(lates) * 1e3:.4f} ms (median), "
            f"{max(lates) * 1e3:.4f} ms (most), last quarter's median {np.median(lates[-max(1, n // 4):]) * 1e3:.4f} ms")

    result = {"attempted": n, "metrics": {}, "peak": peak, "setup_s": setup_s}
    if not trace:
        result["metrics"] = {
            "serve_frames_per_s": {"value": stats.rate(n * b, window_s), "unit": "frames/s"},
            "request_ms_p95": {"value": stats.percentile(walls, 95) * 1e3, "unit": "ms"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        # the spans and walls of the requests the profiler did not slow
        spans = {
            "prep": marks.spans("start", "net_start")[n_prof:],
            "network": marks.spans("net_start", "net_end")[n_prof:],
            "pc_encoder": marks.spans("pc_start", "pc_end")[n_prof:],
            "pose": marks.spans("net_end", "end")[n_prof:],
        }
        path = os.path.join(tmp.name, "trace.json")
        t_x = time.perf_counter()
        prof_ctx.export_chrome_trace(path)
        log(f"trace of {n_prof} requests: {os.path.getsize(path) / 2**20:.1f} MiB written in "
            f"{time.perf_counter() - t_x:.3f} s")
        t_x = time.perf_counter()
        readings = tracing.read_trace(path, "bench.window", ["bench.kpconv"])
        log(f"trace read in {time.perf_counter() - t_x:.3f} s: {readings.get('device_ops_n')} device operations")
        del prof_ctx
        tmp.cleanup()
        result["trace"] = {"kind": "serve", "spans": spans, "readings": readings,
                           "traced_s": window_s - (t_after - t0), "service_s": float(sum(services[n_prof:])),
                           "profiled_pools": pools[:n_prof],
                           "traced_pools": pools[n_prof:]}

    # the program's state goes before the reference runs
    del model, body
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    if trace:
        t_x = time.perf_counter()
        result["trace"]["work"] = pool_work(conf, traffic, seed, device, pool_host, pools, order)
        result["trace"]["peak_flops"] = work.PEAK_FLOPS[kind_conf["precision"]]
        log(f"work counted in {time.perf_counter() - t_x:.3f} s: {result['trace']['work']}")
    t_x = time.perf_counter()
    outputs = sample.kept
    rows = reference_numbers(conf, traffic, seed, device, pool_host, [(r, pools[r]) for r in sorted(outputs)],
                             outputs)
    result["numbers"] = check.worst(rows)
    result["rows"] = rows
    log(f"check of {len(rows)} requests in {time.perf_counter() - t_x:.3f} s")
    return result


class Reservoir:
    """A uniform sample of ``k`` of the window's requests, drawn from the
    seed as the requests come (Algorithm R): request i replaces a kept one
    with probability k / (i + 1).  Keeps each sampled request's outputs,
    by request index, and lets the others go."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.RandomState(np.random.SeedSequence([seed, 4]).generate_state(1)[0])
        self.slots = []  # the request index each slot holds
        self.kept = {}

    def offer(self, i: int, out) -> None:
        if len(self.slots) < self.k:
            self.slots.append(i)
        else:
            slot = int(self.rng.randint(0, i + 1))
            if slot >= self.k:
                return
            del self.kept[self.slots[slot]]
            self.slots[slot] = i
        self.kept[i] = {f: getattr(out, f) for f in out._fields}


def pool_work(conf, traffic, seed, device, pool_host, pools, order) -> dict:
    """Model FLOPs and the KPConv layers' least time of a request on each
    pool batch, by the frozen arithmetic (work.py) on the reference with
    the draws of the first request that used the batch."""
    from benchmark.reference.data.device_pipeline import prepare_samples

    rcfg, rmodel = reference_model(conf, "serve", seed, device)
    rmodel.eval()
    counter = work.Counter(conf["paths"]["serve"]["precision"], rcfg.attention)
    out = {}
    for p in sorted(set(pools)):
        req = pools.index(p)
        hb = {k: v.to(device) for k, v in pool_host[p].items()}
        draws = frames.serve_draws(rcfg, traffic["batch"], seed, req, device)

        def forward():
            with torch.no_grad():
                batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], rcfg, draws["perms"])
                rmodel(batch, mode="test")

        flops, kp_ms, _ = counter.count(forward)
        out[p] = {"flops": flops, "kpconv_bound_ms": kp_ms}
    del rmodel
    return out


def launch_counts() -> dict:
    """The port's kernel wrappers' launch counters, by wrapper."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("cofii2p_tpu_torch.ops.") and name.endswith("_kernel"):
            for attr, fn in vars(mod).items():
                if callable(fn) and getattr(fn, "launches", 0):
                    counts[attr] = fn.launches
    return counts


def control_numbers(conf: dict, traffic: dict, seed: int, device, fmt: str) -> dict:
    """The judged numbers with the lower-precision reference in the
    program's place, on the requests a run's check would draw from a
    window of that many requests."""
    cfg = program_config(conf, "serve")
    pool_host = frames.pool(cfg, seed, traffic["pool_batches"], traffic["batch"], pin=False)
    order = frames.order(seed, traffic["pool_batches"], traffic["check_requests"])
    reqs = [(r, int(order[r])) for r in range(traffic["check_requests"])]
    return check.worst(reference_numbers(conf, traffic, seed, device, pool_host, reqs, None, fmt=fmt))
