"""Adam (train_lib.make_optimizer): device time from the optimizer's step
pre-hook to its post-hook, mean over the traced steps, in ms."""


def read(t):
    v = t["spans"].get("optimizer") if t.get("kind") == "train" else None
    return sum(v) / len(v) if v else None
