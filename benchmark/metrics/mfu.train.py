"""The whole step's share of the card's peak, in %: three times the
train-mode forward's model FLOPs (work.py's frozen count) for each traced
step, over the traced steps' wall time times 165 TFLOP/s (fp32 products
by 3xTF32, the rate the port computes fp32 at within its gates)."""


def read(t):
    if t.get("kind") != "train" or not t.get("traced_steps") or t.get("traced_s", 0) <= 0:
        return None
    return 100.0 * t["work"]["flops"] * t["traced_steps"] / (t["traced_s"] * t["peak_flops"])
