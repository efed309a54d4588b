"""Sample prep (data/device_pipeline.py: perturbation, Morton pyramid,
sampling), with the frames' copy to the card: device time from the
request-start event to CoFiI2P's forward pre-hook, mean over the traced
requests, in ms."""


def read(t):
    v = t["spans"].get("prep") if t.get("kind") == "serve" else None
    return sum(v) / len(v) if v else None
