"""Finds the highest rate a serving cell's traffic sustains (not run by
the benchmark's runs): one closed-loop window gives the service rate,
then open loops at fractions of it show where requests start to wait
behind one another and the backlog grows.

    python3 benchmark/sweep.py --workload kitti-serve-b1 --seed 1 [--seconds 15] [--fractions 0.5,0.7,0.8,0.9,1.0]
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--fractions", default="0.5,0.7,0.8,0.9,1.0")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import serve, spec

    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    wl = spec.workload(spec.benchmark(), args.workload)
    conf, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    traffic = dict(traffic, check_requests=1)

    def window(loop, rate=None):
        lines = []
        res = serve.run(conf, dict(traffic, loop=loop, rate_per_s=rate), args.seed, args.seconds, False,
                        time.perf_counter(), device, log=lines.append)
        m = res["metrics"]
        return {"loop": loop, "rate_per_s": rate, "requests": res["attempted"],
                "frames_per_s": m["serve_frames_per_s"]["value"], "p95_ms": m["request_ms_p95"]["value"],
                "log": lines[-1]}

    closed = window("closed")
    print(json.dumps(closed), flush=True)
    service_rate = closed["requests"] / args.seconds
    for f in (float(x) for x in args.fractions.split(",")):
        print(json.dumps(dict(window("open", round(f * service_rate, 3)), fraction=f)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
