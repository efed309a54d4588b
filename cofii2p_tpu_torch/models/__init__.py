"""Image encoder, KPConv point branch, I2P transformer and CoFiI2P
(models/network.py) in PyTorch."""

from cofii2p_tpu_torch.models.network import CoFiI2P

__all__ = ["CoFiI2P"]
