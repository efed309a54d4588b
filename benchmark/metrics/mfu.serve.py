"""The whole request's share of the card's peak, in %: the model FLOPs of
the traced requests (work.py's frozen count) over the time the card served
them, the sum of each request's time from its start to its poses on the
host (an open loop's waits for an arrival left out), times the peak of the
configuration's precision (989 TFLOP/s bf16; 165 TFLOP/s, 3xTF32, fp32)."""


def read(t):
    if t.get("kind") != "serve" or not t.get("traced_pools") or t.get("service_s", 0) <= 0:
        return None
    flops = sum(t["work"][p]["flops"] for p in t["traced_pools"])
    return 100.0 * flops / (t["service_s"] * t["peak_flops"])
