"""Faults planted under the timed path, for the tests and for the readings
a limit is set from (``readings.py --fault``); never used by a run.

Serving (they wrap the eval body): the pose altered where it is produced,
the fine match moved by a pixel, half of the batch left out (the answers
for the rest stand in).  Training (they wrap the train step): a step that
leaves the state unchanged, half of the batch left out with the mean
taken over the rest.
"""

from __future__ import annotations

import torch


def alter_pose(body):
    def broken(*args, **kwargs):
        out = body(*args, **kwargs)
        return out._replace(R=torch.nan_to_num(out.R) + 0.05)

    return broken


def alter_match(body):
    def broken(*args, **kwargs):
        out = body(*args, **kwargs)
        return out._replace(fine_xy=out.fine_xy + 1.0)

    return broken


def _half_draws(draws: dict, h: int) -> dict:
    out = {"perms": [p[:h] for p in draws["perms"]]}
    if "gumbel" in draws:
        out["gumbel"] = draws["gumbel"][:h]
    if "keypoint_noise" in draws:
        out["keypoint_noise"] = {k: v[:h] for k, v in draws["keypoint_noise"].items()}
    return out


def serve_half_batch(body):
    def broken(host_batch, draws):
        h = host_batch["pc"].shape[0] // 2
        out = body({k: v[:h] for k, v in host_batch.items()}, draws=_half_draws(draws, h))
        return type(out)(*(torch.cat([x, x]) for x in out))

    return broken


def unchanged(model, optimizer, step):
    def broken(host_batch, draws):
        real = optimizer.step
        optimizer.step = lambda *a, **k: None
        try:
            return step(host_batch, draws)
        finally:
            optimizer.step = real

    return broken


def train_half_batch(model, optimizer, step):
    def broken(host_batch, draws):
        h = host_batch["pc"].shape[0] // 2
        return step({k: v[:h] for k, v in host_batch.items()}, _half_draws(draws, h))

    return broken


SERVE = {"alter_pose": alter_pose, "alter_match": alter_match, "half_batch": serve_half_batch}
TRAIN = {"unchanged": unchanged, "half_batch": train_half_batch}
