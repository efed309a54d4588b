"""Checkpointing of the whole training state: model parameters and
BatchNorm statistics (the state dict), optimizer moments and step
(counterpart of cofii2p_tpu/utils/checkpoint.py's save/restore/latest).

The format is the port's own, one ``torch.save`` file per step: the JAX
package's orbax directories cannot be read without JAX.  The reference
``.t7`` importer and exporter are not ported yet.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> str:
    """Write ``ckpt_dir/step_XXXXXXXX.pt``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pt"))
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load a checkpoint into ``model`` (strictly) and ``optimizer``;
    returns its step."""
    state = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("step_") and f.endswith(".pt"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None
