"""Host data (the KITTI and nuScenes loaders, numpy synthetic frames, fixture
trees) and sample preparation on the device (torch)."""

from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
from cofii2p_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["prepare_samples", "SyntheticDataset"]
