"""Per-object foreground point dataset (``nuscenes-object``).

Port of the JAX package's ``datasets/object_dataset.py::NuscObjectDataset``:
a GT-database pickle (class name → object infos) → box-frame
``num_samples``-point clouds with their box encodings and class ids.  The
order is shuffled once from ``random.Random(seed)``; an object that is not
valid is replaced by one drawn at random, and the resampling draws from
the sample's ``np.random.RandomState`` (the JAX dataset's global
``random`` / ``np.random``, in the same order).
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

from . import transforms as T
from .nuscenes import SampleDraws, sample_seed


class NuscObjectDataset:
    def __init__(self, cfg, fg_objects_dict: dict | None = None, seed: int = 0):
        data_cfg = cfg.data if hasattr(cfg, "data") else cfg
        self.data_cfg = data_cfg
        self.data_root = data_cfg.data_root
        self.num_samples = data_cfg.num_samples
        self.class_names = list(data_cfg.class_names)
        self.seed = seed

        if fg_objects_dict is None:
            with open(data_cfg.pkl_path, "rb") as f:
                fg_objects_dict = pickle.load(f)
        self.data, self.class_samples = [], []
        for class_idx, name in enumerate(self.class_names):
            objs = fg_objects_dict.get(name, [])
            self.data.extend(objs)
            self.class_samples.extend([class_idx] * len(objs))
        combined = list(zip(self.data, self.class_samples))
        random.Random(seed).shuffle(combined)
        if combined:
            self.data, self.class_samples = map(list, zip(*combined))

    def __len__(self):
        return len(self.data)

    def _load_points(self, fg_path: str) -> np.ndarray:
        return np.fromfile(os.path.join(self.data_root, fg_path), dtype=np.float32).reshape(-1, 5)[:, :4]

    def __getitem__(self, idx: int) -> dict:
        return self.sample(idx, sample_seed(self.seed, 0, idx))

    def sample(self, idx: int, seed: int) -> dict:
        return self._sample(idx, SampleDraws(seed))

    def _sample(self, idx: int, draws: SampleDraws) -> dict:
        info = self.data[idx]
        box3d = np.asarray(info["box3d_lidar"][:7])
        if not T.object_is_valid(info["num_points_in_gt"], box3d):
            return self._sample(draws.py.randint(0, len(self) - 1), draws)
        pts = info["points"] if "points" in info else self._load_points(info["path"])
        pts = T.sample_points(T.norm_fg_points(pts, box3d), self.num_samples, draws.np)
        return {
            "fg_encoding_box": T.object_encoding_boxes_3d(box3d),
            "fg_points": pts.astype(np.float32),
            "fg_class": np.array([self.class_samples[idx]]),
        }

    def collate_fn(self, batch: list[dict]) -> dict:
        return {
            "fg_encoding_box": np.stack([b["fg_encoding_box"] for b in batch]),
            "fg_points": np.stack([b["fg_points"] for b in batch]),
            "fg_class": np.concatenate([b["fg_class"] for b in batch]),
            "batch_size": len(batch),
        }
