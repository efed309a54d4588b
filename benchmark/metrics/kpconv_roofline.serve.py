"""The KPConv layers' share of their roofline, in %: the least time for
their work (work.py, from shapes and in-reach pairs, summed over the
profiled requests) over the device time of the kernels launched inside
models/kpconv.py::KPConv forwards in the profiled stretch."""


def read(t):
    if t.get("kind") != "serve":
        return None
    device_ms = t["readings"].get("scoped_ms", {}).get("bench.kpconv")
    if not device_ms:
        return None
    bound = sum(t["work"][p]["kpconv_bound_ms"] for p in t["profiled_pools"])
    return 100.0 * bound / device_ms
