"""Sample prep with the supervision (train_lib.py::prepare_batch ->
data/device_pipeline.py), with the frames' copy to the card: device time
from the step-start event to CoFiI2P's forward pre-hook, mean over the
traced steps, in ms."""


def read(t):
    v = t["spans"].get("prep") if t.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
