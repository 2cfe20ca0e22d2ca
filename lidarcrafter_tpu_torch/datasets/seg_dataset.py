"""nuScenes lidarseg range-image dataset (RangeNet training).

Port of the JAX package's ``datasets/seg_dataset.py``: the info pickle's
raw ``.bin`` clouds and lidarseg ``uint8`` labels; raw labels map through
the learning map shifted by one (0 stays the void / empty-pixel class, of
loss weight 0), ride as an extra point feature through the range
projection (``ops/projection.py::points_to_range_image``, on the CPU), and
every channel is zeroed at empty pixels.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..ops.projection import points_to_range_image
from .transforms import NUSC_LEARNING_MAP

NUM_SEG_CLASSES = 17  # 16 mapped classes + void


def seg_learning_lut() -> np.ndarray:
    """Raw nuScenes label → training label (mapped + 1; the rest → 0)."""
    lut = np.zeros(32 + 100, np.int64)
    for k, v in NUSC_LEARNING_MAP.items():
        lut[k] = v + 1  # -1 (ignored) → 0 = void
    return lut


class NuscSegDataset:
    """``__getitem__`` → {'xyz', 'reflectance', 'depth', 'mask' (H, W, C),
    'segment' (H, W) int32}, numpy."""

    def __init__(self, info_path: str, data_root: str, resolution=(32, 1024), min_depth: float = 1.45,
                 max_depth: float = 80.0, fov_up: float = 10.0, fov_down: float = -30.0):
        self.data_root = data_root
        self.resolution = tuple(resolution)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.fov_up, self.fov_down = fov_up, fov_down
        with open(info_path, "rb") as f:
            self.data = pickle.load(f)
        self.lut = seg_learning_lut()

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> dict:
        info = self.data[idx % len(self.data)]
        points = np.fromfile(os.path.join(self.data_root, info["lidar_path"]), dtype=np.float32).reshape(-1, 5)[:, :4]
        if "gt_segment_path" in info:
            raw = np.fromfile(os.path.join(self.data_root, info["gt_segment_path"]), dtype=np.uint8)
            segment = self.lut[raw].astype(np.float32)
        else:
            segment = np.ones((points.shape[0],), np.float32)
        return self.project(points, segment)

    def project(self, points: np.ndarray, segment: np.ndarray) -> dict:
        H, W = self.resolution
        img = points_to_range_image(
            torch.as_tensor(np.concatenate([points, segment[:, None]], 1), dtype=torch.float32),
            H=H, W=W, min_depth=self.min_depth, max_depth=self.max_depth, fov_up=self.fov_up,
            fov_down=self.fov_down,
        ).numpy()
        img = img * img[..., 6:7]  # zero every channel at empty pixels
        return {
            "xyz": img[..., :3],
            "reflectance": img[..., 3:4] / 255.0,
            "segment": img[..., 4].astype(np.int32),
            "depth": img[..., 5:6],
            "mask": img[..., 6:7],
        }

    @staticmethod
    def collate_fn(batch: list[dict]) -> dict:
        return {k: np.stack([b[k] for b in batch]) for k in batch[0]}

    @staticmethod
    def rangenet_input(batch: dict) -> np.ndarray:
        """Collated batch → (B, 5, H, W) [depth, x, y, z, remission], the
        port's RangeNet input (channels first)."""
        nhwc = np.concatenate([batch["depth"], batch["xyz"], batch["reflectance"]], axis=-1)
        return np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2))
