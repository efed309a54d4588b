"""The losses, the backward and the gradient norm (losses.py,
train_lib.loss_fn, autograd through the port's kernels): device time
from CoFiI2P's forward post-hook to the optimizer's step pre-hook, mean
over the traced steps, in ms."""


def read(t):
    v = t["spans"].get("backward") if t.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
