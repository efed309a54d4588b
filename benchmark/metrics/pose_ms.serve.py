"""The fine match and the pose solver (models/network.py::fine_match_xy,
pose/ransac.py under its captured CUDA graph): device time from CoFiI2P's
forward post-hook to the request-end event, mean over the traced requests,
in ms."""


def read(t):
    v = t["spans"].get("pose") if t.get("kind") == "serve" else None
    return sum(v) / len(v) if v else None
