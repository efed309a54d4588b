"""The network in train mode (models/network.py, CoFiI2P.forward):
device time from its forward pre-hook to its post-hook, mean over the
traced steps, in ms."""


def read(t):
    v = t["spans"].get("forward") if t.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
