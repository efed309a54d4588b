"""Data parallelism over torch.distributed: the device mesh and the batch
sharding (counterpart of cofii2p_tpu/parallel)."""

from cofii2p_tpu_torch.parallel.mesh import make_mesh, shard_host_batch

__all__ = ["make_mesh", "shard_host_batch"]
