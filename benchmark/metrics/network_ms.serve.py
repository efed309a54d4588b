"""The network in test mode (models/network.py, CoFiI2P.forward):
device time from its forward pre-hook to its post-hook, mean over the
traced requests, in ms."""


def read(t):
    v = t["spans"].get("network") if t.get("kind") == "serve" else None
    return sum(v) / len(v) if v else None
