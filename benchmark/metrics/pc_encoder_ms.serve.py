"""The KPConv point branch (models/kpconv.py, KPConvFPN, the model's
pc_encoder): device time from its forward pre-hook to its post-hook, mean
over the traced requests, in ms."""


def read(t):
    v = t["spans"].get("pc_encoder") if t.get("kind") == "serve" else None
    return sum(v) / len(v) if v else None
