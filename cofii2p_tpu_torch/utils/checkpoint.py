"""Checkpointing of the whole training state: model parameters and
BatchNorm statistics (the state dict), optimizer moments and step
(counterpart of cofii2p_tpu/utils/checkpoint.py's save/restore/latest),
and the reference's ``.t7`` state dicts (import_t7/export_t7).

The training format is the port's own, one ``torch.save`` file per step:
the JAX package's orbax directories cannot be read without JAX.  A ``.t7``
is the reference's bare state dict; the port's modules carry the
reference's names and layouts, so it loads by name.
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


# parameters a reference checkpoint registers and its forward never uses:
# the fine positional MLPs, the commented-out img_feature_layer and the
# torchvision classifier head (cofii2p_tpu/utils/checkpoint.py:193-204)
REFERENCE_UNUSED = ("fine_img_pos_encoding", "fine_pc_pos_encoding", "img_feature_layer.", "img_encoder.backbone.fc.")


def import_t7(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.t7``/``.pth`` state dict into ``model`` (the
    port's CoFiI2P), strictly: every tensor of the model must be in the
    file except BatchNorm's ``num_batches_tracked`` bookkeeping, and every
    entry of the file must be a tensor the model has or one of
    ``REFERENCE_UNUSED``.  Raises naming the offending keys.  Each KPConv's
    own ``kernel_points`` come with it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise TypeError(f"{path}: a state dict was expected, got {type(sd).__name__}")
    non_tensor = sorted(k for k, v in sd.items() if not torch.is_tensor(v))
    if non_tensor:
        raise TypeError(f"{path}: entries that are not tensors: {non_tensor}")
    own = model.state_dict()
    unexpected = sorted(k for k in sd if k not in own and not any(tag in k for tag in REFERENCE_UNUSED))
    missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
    if unexpected or missing:
        raise KeyError(f"{path}: missing {missing}, unexpected {unexpected}")
    merged = {k: sd.get(k, v) for k, v in own.items()}
    model.load_state_dict(merged, strict=True)
    return model


def export_t7(model: torch.nn.Module, path: str) -> dict:
    """Write ``model``'s state dict as a reference-layout ``.t7`` (the
    inverse of :func:`import_t7`; cofii2p_tpu/utils/checkpoint.py:213-330
    reads it).  Returns the dict written."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save(sd, path)
    return sd
