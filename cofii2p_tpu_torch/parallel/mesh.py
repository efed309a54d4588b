"""Device mesh and batch sharding for data-parallel training (counterpart
of cofii2p_tpu/parallel/mesh.py).

The JAX package shards the batch axis over a 1-D ``"dp"`` mesh and lets
XLA's SPMD partitioning insert the gradient all-reduce.  Here each process
(one a card, launched by ``torchrun``; NCCL on cards, gloo on the CPU)
holds a replica of the parameters and its rows of the global batch; the
trainer averages the gradients over the group, the decoder's BatchNorms
all-reduce their batch statistics, and every loss and metric normalised
over the batch is reduced globally (train_lib.py), so a step equals the
one-process step on the global batch.  Without a process group the mesh is
a world of one and nothing communicates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class LocalMesh:
    """A world of one, the mesh of a process with no process group: the
    part of ``DeviceMesh``'s interface the port reads."""

    mesh_dim_names = ("dp",)

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self) -> int:
        return 1

    def get_local_rank(self) -> int:
        return 0

    def get_group(self):
        return None


def _device_type(devices) -> str:
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(devices, str):
        return torch.device(devices).type
    return torch.device(devices[0]).type


def make_mesh(devices=None):
    """A 1-D ``"dp"`` DeviceMesh over every rank of the process group
    (``init_device_mesh``), or a :class:`LocalMesh` when no group is
    initialised.  ``devices``: a device type, or a list of devices whose
    type is taken; by default the card's when there is one."""
    device_type = _device_type(devices)
    if not (dist.is_available() and dist.is_initialized()):
        return LocalMesh(device_type)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("dp",))


def dp_group(mesh):
    """The mesh's process group, or None for a world of one without one."""
    return mesh.get_group() if mesh is not None else None


def is_sharded(bsz: int, mesh) -> bool:
    """JAX's rule (mesh.py:26-40): the batch axis is sharded only when it
    divides evenly over the mesh; otherwise every rank holds it whole."""
    n = mesh.size()
    return bsz % n == 0 and bsz >= n


def local_rows(x: torch.Tensor, bsz: int, mesh) -> torch.Tensor:
    """This rank's rows of a batched tensor (leading axis ``bsz``) under
    the sharding rule; an unbatched tensor, or an unsharded batch, whole."""
    if mesh.size() == 1 or x.ndim == 0 or x.shape[0] != bsz or not is_sharded(bsz, mesh):
        return x
    per = bsz // mesh.size()
    r = mesh.get_local_rank()
    return x[r * per:(r + 1) * per]


def shard_host_batch(host_batch: dict, mesh, device=None) -> dict:
    """A stacked host batch (numpy arrays or tensors) on this rank's device:
    of each batched entry this rank's rows, each unbatched one whole.
    ``device`` defaults to the current card for a CUDA mesh, else the CPU."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    bsz = np.shape(host_batch["img"])[0]
    return {k: local_rows(torch.as_tensor(v), bsz, mesh).to(device) for k, v in host_batch.items()}


def shard_tree(tree, bsz: int, mesh):
    """This rank's rows of every batched tensor in a nested dict/list (the
    random draws of a global batch: each rank takes its slice of the same
    draws, so they do not change with the world size)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, bsz, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, bsz, mesh) for v in tree)
    return local_rows(tree, bsz, mesh)


def all_reduce_sum_(tensors, mesh) -> None:
    """Sum each tensor over the mesh's group, in place; nothing for a world
    of one without a group."""
    group = dp_group(mesh)
    if group is None:
        return
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def sync_batch_norms(model: torch.nn.Module, mesh) -> None:
    """Point every BatchNorm2d of the port at the mesh's group, so that in
    training mode it normalises with the global batch's statistics."""
    from cofii2p_tpu_torch.models.resnet import BatchNorm2d

    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = dp_group(mesh)
