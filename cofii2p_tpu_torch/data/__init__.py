"""Host data (the KITTI and nuScenes loaders, numpy synthetic frames, fixture
trees) and sample preparation on the device (torch)."""
