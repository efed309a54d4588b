"""The KPConv layers' share of their roofline over a training step, in
%: the least time for their forward and backward work (work.py, from
shapes and in-reach pairs, for the first step's batch) times the profiled
steps, over the device time of the kernels launched inside
models/kpconv.py::KPConv forwards and inside the backward of the
operations those forwards ran, in the profiled stretch."""


def read(t):
    if t.get("kind") != "train":
        return None
    device_ms = t["readings"].get("scoped_ms", {}).get("bench.kpconv")
    if not device_ms:
        return None
    return 100.0 * t["work"]["kpconv_bound_ms"] * t["profiled_steps"] / device_ms
