"""In-memory dataset over box / point dicts.

Port of the JAX package's ``datasets/custom_dataset.py::CustomDataset``:
the projection and conditioning of :class:`NuscDataset` driven from dicts
of ``points``, ``gt_boxes`` and ``gt_names`` (the ``val`` split: no draws).
"""

from __future__ import annotations

import numpy as np

from .nuscenes import NuscDataset, SampleDraws


class CustomDataset(NuscDataset):
    def __init__(self, cfg=None, custom_box_infos: list[dict] | None = None, task: str | None = "layout_cond"):
        if cfg is None:
            from ..configs import get_config

            cfg = get_config("nuscenes-box-layout-v2")
        self.cfg = cfg
        self.data_cfg = cfg.data if hasattr(cfg, "data") else cfg
        self.task = task
        self.data_root = self.data_cfg.data_root
        self.split = "val"
        self.class_names = list(self.data_cfg.class_names)
        self.resolution = tuple(self.data_cfg.resolution)
        self.seed = 0
        self.data = custom_box_infos or []

    def _sample(self, idx: int, draws: SampleDraws) -> dict:
        info = self.data[idx]
        out = {
            "points": np.asarray(info["points"], np.float32),
            "gt_boxes": np.asarray(info["gt_boxes"], np.float32)[:, :7],
            "gt_names": list(info["gt_names"]),
        }
        out.update(self.project(out["points"]))
        return self.pre_process(out)
