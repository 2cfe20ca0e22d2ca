"""Data augmentation: world transforms and GT-database sampling.

Port of the JAX package's ``datasets/augmentor.py`` (OpenPCDet's
augmentor): world flips, rotation and scaling of (points, boxes[,
velocities]), and GT-paste sampling that rejects an object whose BEV box
overlaps one already in the scene (``ops/iou3d.py::boxes_iou_bev`` on the
CPU).  Host numpy; every draw comes from an explicit
``np.random.RandomState``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import transforms as T
from .nuscenes import host_points_in_boxes


def limit_period(val, offset=0.5, period=2 * np.pi):
    return val - np.floor(val / period + offset) * period


def random_flip_along_x(gt_boxes, points, enable=None, rng=None):
    """Mirror y (and the yaw, and the y velocity) with probability 1/2, or
    as ``enable`` says."""
    if enable is None:
        enable = bool(rng.choice([False, True]))
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 8:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points, enable


def random_flip_along_y(gt_boxes, points, enable=None, rng=None):
    """Mirror x (the yaw to −(yaw + π), and the x velocity)."""
    if enable is None:
        enable = bool(rng.choice([False, True]))
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points, enable


def global_rotation(gt_boxes, points, rot_range, noise_rotation=None, rng=None):
    """Rotate the scene about z by an angle uniform in ``rot_range`` (or
    ``noise_rotation``)."""
    if noise_rotation is None:
        noise_rotation = rng.uniform(rot_range[0], rot_range[1])
    ang = np.array([noise_rotation])
    points = T._rotate_points_along_z_np(points[np.newaxis], ang)[0]
    gt_boxes[:, :3] = T._rotate_points_along_z_np(gt_boxes[np.newaxis, :, :3], ang)[0]
    gt_boxes[:, 6] += noise_rotation
    if gt_boxes.shape[1] > 8:
        vel = np.hstack([gt_boxes[:, 7:9], np.zeros((len(gt_boxes), 1))])
        gt_boxes[:, 7:9] = T._rotate_points_along_z_np(vel[np.newaxis], ang)[0][:, :2]
    return gt_boxes, points, noise_rotation


def global_scaling(gt_boxes, points, scale_range, rng=None):
    """Scale the scene by a factor uniform in ``scale_range`` (none when
    the range is narrower than 1e-3)."""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points, 1.0
    s = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:] *= s
    return gt_boxes, points, s


class GTDatabaseSampler:
    """GT-paste augmentation: per class, up to ``sample_groups[name]``
    database objects (of at least ``min_points`` points) drawn from ``rng``
    without replacement; one whose BEV box overlaps (IoU > 1e-3) a scene box
    or an object placed before is rejected; the scene points inside the
    placed boxes are removed and the objects' box-centred points added."""

    def __init__(self, db_infos: dict, class_names, sample_groups: dict[str, int], min_points: int = 5,
                 rng: np.random.RandomState | None = None, load_points_fn=None):
        self.class_names = list(class_names)
        self.sample_groups = dict(sample_groups)
        self.rng = rng or np.random.RandomState(0)
        self.load_points_fn = load_points_fn
        self.db_infos = {name: [i for i in infos if i.get("num_points_in_gt", 1e9) >= min_points]
                         for name, infos in db_infos.items()}

    def _sample_class(self, name, num):
        infos = self.db_infos.get(name, [])
        if not infos:
            return []
        idx = self.rng.choice(len(infos), min(num, len(infos)), replace=False)
        return [infos[i] for i in idx]

    def __call__(self, data_dict: dict) -> dict:
        from ..ops.iou3d import boxes_iou_bev

        gt_boxes = np.asarray(data_dict["gt_boxes"], np.float64)
        gt_names = list(data_dict["gt_names"])
        points = np.asarray(data_dict["points"])

        placed_boxes, placed_names, placed_points = [], [], []
        existing = gt_boxes[:, :7].astype(np.float32)
        for name, num in self.sample_groups.items():
            for info in self._sample_class(name, num):
                box = np.asarray(info["box3d_lidar"][:7], np.float32)
                all_prev = np.concatenate([existing, np.stack(placed_boxes)]) if placed_boxes else existing
                if len(all_prev) > 0:
                    iou = boxes_iou_bev(torch.from_numpy(box[None]), torch.from_numpy(all_prev)).numpy()
                    if iou.max() > 1e-3:
                        continue
                obj_pts = (np.asarray(info["points"], np.float32) if "points" in info
                           else self.load_points_fn(info["path"]))
                placed = obj_pts.copy()  # database points are box-centred
                placed[:, :3] += box[:3]
                placed_boxes.append(box)
                placed_names.append(name)
                placed_points.append(placed)

        if placed_boxes:
            placed_arr = np.stack(placed_boxes)
            member = host_points_in_boxes(points.astype(np.float32), placed_arr)
            points = np.concatenate([points[member.sum(axis=0) == 0]] + placed_points, axis=0)
            pad = gt_boxes.shape[1] - 7
            placed_full = np.pad(placed_arr, ((0, 0), (0, pad))) if pad > 0 else placed_arr
            gt_boxes = np.concatenate([gt_boxes, placed_full], axis=0)
            gt_names = gt_names + placed_names

        data_dict = dict(data_dict)
        data_dict.update(points=points, gt_boxes=gt_boxes, gt_names=np.asarray(gt_names))
        return data_dict


class DataAugmentor:
    """The augmentation queue of ``config``, a list of ``{"name": ...,
    **kwargs}``: ``gt_sampling`` (``sample_groups``, ``min_points``; needs
    ``db_infos``), ``random_world_flip`` (``along_axis_list``),
    ``random_world_rotation`` (``rot_range``), ``random_world_scaling``
    (``scale_range``); all draw from ``rng``.  After the queue the yaws are
    wrapped into [-π, π) and a ``gt_boxes_mask`` is applied."""

    def __init__(self, config: list[dict], class_names, rng=None, db_infos=None, load_points_fn=None):
        self.rng = rng or np.random.RandomState(0)
        self.queue = []
        for cur in config:
            name = cur["name"]
            if name == "gt_sampling":
                self.queue.append(GTDatabaseSampler(
                    db_infos or {}, class_names, cur.get("sample_groups", {}), min_points=cur.get("min_points", 5),
                    rng=self.rng, load_points_fn=load_points_fn))
            elif name == "random_world_flip":
                self.queue.append(self._flip(cur.get("along_axis_list", ["x"])))
            elif name == "random_world_rotation":
                self.queue.append(self._apply(global_rotation, cur.get("rot_range", [-np.pi / 4, np.pi / 4])))
            elif name == "random_world_scaling":
                self.queue.append(self._apply(global_scaling, cur.get("scale_range", [0.95, 1.05])))
            else:
                raise ValueError(f"unknown augmentation: {name}")

    def _flip(self, axes):
        def flip(dd):
            for ax in axes:
                fn = random_flip_along_x if ax == "x" else random_flip_along_y
                dd["gt_boxes"], dd["points"], _ = fn(dd["gt_boxes"], dd["points"], rng=self.rng)
            return dd

        return flip

    def _apply(self, fn, value_range):
        def apply(dd):
            dd["gt_boxes"], dd["points"], _ = fn(dd["gt_boxes"], dd["points"], value_range, rng=self.rng)
            return dd

        return apply

    def __call__(self, data_dict: dict) -> dict:
        for fn in self.queue:
            data_dict = fn(data_dict)
        data_dict["gt_boxes"][:, 6] = limit_period(data_dict["gt_boxes"][:, 6])
        if "gt_boxes_mask" in data_dict:
            m = data_dict.pop("gt_boxes_mask")
            data_dict["gt_boxes"] = data_dict["gt_boxes"][m]
            data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[m]
        return data_dict
