"""Dataset registry (name -> class; ref data_loaders/__init__.py:32-46),
the same names as the JAX package's `dataset_dict`."""
from __future__ import annotations

from .collections import IBRNetCollectedDataset, LLFFDataset
from .datasets import LLFFTestDataset, SyntheticPlanesDataset
from .extra_datasets import (
    DeepVoxelsDataset,
    GoogleScannedDataset,
    KittiDataset,
    RealEstateDataset,
    SpacesFreeDataset,
)
from .nerf_synthetic import NerfSyntheticDataset
from .scannet import ScannetDataset
from .waymo import WaymoStaticDataset

dataset_dict = {
    "llff": LLFFDataset,
    "llff_test": LLFFTestDataset,
    "ibrnet_collected": IBRNetCollectedDataset,
    "waymo": WaymoStaticDataset,
    "nerf_synthetic": NerfSyntheticDataset,
    "scannet": ScannetDataset,
    "synthetic": SyntheticPlanesDataset,
    "realestate": RealEstateDataset,
    "kitti": KittiDataset,
    "deepvoxels": DeepVoxelsDataset,
    "google_scanned": GoogleScannedDataset,
    "spaces": SpacesFreeDataset,
}
