"""The readings a cell's correctness limits are set from (not run by the
benchmark's own runs): the program's judged numbers over many seeds, and
the lower-precision control's (harness/control.py) over a few, at the
cell's own sizes, all in one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 [--seconds 3]

``--fault NAME`` plants a fault of harness/faults.py in the program's runs.
Prints one JSON line per seed, then each number's largest program reading
and smallest control reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="", help="plant this fault (harness/faults.py) in the program's runs")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import faults, spec
    from benchmark.harness.control import CONTROL

    if not torch.cuda.is_available():
        print("readings.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    conf, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    if traffic["kind"] == "serve":
        from benchmark.harness import serve as cell
    else:
        from benchmark.harness import train as cell
    precision = conf["paths"][traffic["kind"]]["precision"]
    fault = (faults.SERVE if traffic["kind"] == "serve" else faults.TRAIN)[args.fault] if args.fault else None
    program, control = {}, {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        res = cell.run(conf, traffic, s, args.seconds, False, time.perf_counter(), device,
                       log=lambda m: print(m, file=sys.stderr, flush=True), fault=fault)
        program[s] = res["numbers"]
        print(json.dumps({"side": "program", "fault": args.fault, "seed": s, "numbers": res["numbers"]}), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        numbers = cell.control_numbers(conf, traffic, s, device, CONTROL[precision])
        control[s] = numbers
        print(json.dumps({"side": "control", "fmt": CONTROL[precision], "seed": s, "numbers": numbers}), flush=True)
    names = list((program or control)[next(iter(program or control))])
    summary = {k: {"program_max": max((v[k] for v in program.values()), default=None),
                   "control_min": min((v[k] for v in control.values()), default=None)} for k in names}
    print(json.dumps({"workload": wl["name"], "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
