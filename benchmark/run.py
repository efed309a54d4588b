"""Runs one cell of the port's benchmark once and prints its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
its correctness limits are ``limits/<workload>.json`` and each per-layer
metric's reader is ``metrics/<metric>.py``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics with ``--trace 0``, the per-layer ones
with ``--trace 1``), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds every number compared with its limit, which are also
the last lines of standard error.  Needs as many CUDA devices as the cell
asks for; exits non-zero without a result otherwise.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches stay inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "cofii2p_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi unavailable"


def run_cell(bench: dict, wl: dict, conf: dict, traffic: dict, limits: dict, seed: int, seconds: float,
             trace: bool, t_start: float, device, fault=None, log=log):
    """Everything a run does once a device is chosen: the cell's set-up,
    window and check.  Returns (the result's object, the judged numbers,
    set-up seconds).  ``fault`` (tests only) breaks the timed path."""
    import torch

    from benchmark.harness import check, spec

    per_layer = spec.cell_metrics(bench, wl["name"], "per_layer") if trace else []
    readers = {m["name"]: spec.reader(m["name"]) for m in per_layer}
    end_to_end = [m["name"] for m in spec.cell_metrics(bench, wl["name"], "end_to_end")]
    if traffic["kind"] == "serve":
        from benchmark.harness import serve as cell
    elif traffic["kind"] == "train":
        from benchmark.harness import train as cell
    else:
        raise KeyError(f"traffic kind {traffic['kind']!r} is not 'serve' or 'train'")
    res = cell.run(conf, traffic, seed, seconds, trace, t_start, device, log=log, fault=fault)
    judged = check.judge(res["numbers"], limits)
    if trace:
        metrics = {}
        units = {m["name"]: m["unit"] for m in per_layer}
        for name, read in readers.items():
            value = read(res["trace"])
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        metrics = {k: v for k, v in res["metrics"].items() if k in end_to_end}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": wl["chips"],
           "memory_peak_bytes": int(res["peak"])}
    # a checked request or step fails when any of its numbers is over its limit
    failed = sum(1 for row in res["rows"] if not all(ok for *_, ok in check.judge(row, limits)))
    out = {"correct": all(ok for *_, ok in judged), "attempted": res["attempted"], "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        rd = res["trace"]["readings"]
        dev["busy_s"], dev["window_s"] = rd.get("busy_s", 0.0), rd.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": rd.get("device_ops", []), "idle_gaps": rd.get("idle_gaps", [])}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim, _ in judged}
    return out, judged, res["setup_s"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    conf, traffic, limits = spec.config(wl["config"]), spec.traffic(wl["traffic"]), spec.limits(wl["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['name']} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {card_line()}")
    log(f"cell {wl['name']}: config {wl['config']}, traffic {wl['traffic']}, seed {args.seed}, "
        f"seconds {args.seconds}, trace {args.trace}")
    out, judged, setup_s = run_cell(bench, wl, conf, traffic, limits, args.seed, args.seconds, bool(args.trace),
                                    T_START, device)

    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 3
    log(f"setup_s {setup_s}")
    for k, v, lim, ok in judged:
        print(f"check {k} {v!r} limit {lim!r} {'ok' if ok else 'OVER'}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
