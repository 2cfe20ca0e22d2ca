"""Temporal previous-frame conditioned dataset (``nuscenes-temporal``).

Port of the JAX package's ``datasets/temporal_dataset.py::NuscTempDataset``:
each frame with its previous frame moved into the current lidar frame
(``sensor2lidar_*``) and projected with a per-point label channel (the
class id + 1 of the box a point lies in, 0 for the background): the
(H, W, 7) ``prev_cond`` ``[x, y, z, intensity, label, depth, valid]``.
"""

from __future__ import annotations

import numpy as np

from .nuscenes import NuscDataset, SampleDraws, host_points_in_boxes, project_points


class NuscTempDataset(NuscDataset):
    def __init__(self, cfg, infos=None, seed: int = 0):
        super().__init__(cfg, infos=infos, seed=seed)
        self.data_dict = {info["token"]: info for info in self.data}
        self.data = [di for di in self.data
                     if di.get("prev_info", {}).get("valid") and di["prev_info"]["token"] in self.data_dict]

    def get_prev_points(self, prev_data_info: dict, prev_info: dict) -> np.ndarray:
        """The previous cloud with its (N, 1) labels, in the current lidar
        frame."""
        prev_points = self._load_points(prev_data_info)
        labels = np.zeros((len(prev_points), 1), np.float32)
        names = prev_data_info["scene_graph"]["keep_box_names"][1:]
        boxes = prev_data_info["scene_graph"]["keep_box"][1:, :7]
        classes = np.array([self.class_names.index(n) for n in names]) + 1
        if len(boxes):
            member = host_points_in_boxes(prev_points, boxes)
            for box_id, cls in enumerate(classes):
                labels[member[box_id] > 0, 0] = cls
        pts = np.concatenate([prev_points, labels], axis=1)
        rot = np.asarray(prev_info["sensor2lidar_rotation"])
        trans = np.asarray(prev_info["sensor2lidar_translation"])
        pts[:, :3] = pts[:, :3] @ rot.T
        pts[:, :3] -= -(rot.T @ trans.reshape(3, 1)).ravel()
        return pts

    def get_prev_as_condition(self, info: dict) -> np.ndarray:
        """The (H, W, 7) previous frame, each pixel masked by its valid
        channel."""
        prev = self.data_dict[info["prev_info"]["token"]]
        img = project_points(self.get_prev_points(prev, info["prev_info"]), self.data_cfg, self.resolution)
        return img * img[..., -1:]

    def _sample(self, idx: int, draws: SampleDraws) -> dict:
        info = self.data[idx]
        out = {"token": info["token"]}
        out.update(self.project(self._load_points(info)))
        out["prev_cond"] = self.get_prev_as_condition(info)
        return out
