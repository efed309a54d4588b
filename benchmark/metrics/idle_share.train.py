"""The device's idle share in the profiled stretch of training, in %:
1 - (union of the device intervals of kernels, copies and sets) / the
stretch's wall time."""


def read(t):
    r = t.get("readings", {})
    if t.get("kind") != "train" or not r.get("window_s") or not r.get("device_ops_n"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
