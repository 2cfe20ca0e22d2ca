"""nuScenes range-image dataset (host input pipeline).

Port of the JAX package's ``datasets/nuscenes.py::NuscDataset``: info
pickles → fixed-shape numpy samples, collated by stacking.  The tasks of
``pre_process``:

- ``None``                       → plain frames (xyz, reflectance, depth, mask)
- ``layout_generation``          → + scaled boxes, 2D boxes, condition masks,
                                   and the scene graph (``SceneGraphAssigner``)
- ``layout_cond``                → + the 13-slot padded box condition
- ``autoregressive_generation``  → + the previous frame warped into this one

Clouds project with the port's ``ops/projection.py::points_to_range_image``
on CPU tensors.  Every random draw comes from the sample's own generators,
a ``random.Random(s)`` and an ``np.random.RandomState(s)`` for a seed ``s``
that the loader derives from (seed, epoch, index) (:func:`sample_seed`), in
the JAX dataset's order (which draws from the global ``random`` /
``np.random``), so threads that load samples at once give the same batches
as one thread.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Any

import numpy as np
import torch

from ..metrics.temporal import relative_gt_transform
from ..ops.points import points_in_boxes
from ..ops.projection import convert_boxes_to_2d, points_to_range_image
from . import transforms as T


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of sample ``index`` in epoch ``epoch`` of a run seeded
    ``seed``."""
    return int(np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0])


class SampleDraws:
    """The generators one sample draws from: ``py`` for the JAX dataset's
    draws from ``random``, ``np`` for those from ``np.random``."""

    def __init__(self, seed: int):
        self.py = random.Random(seed)
        self.np = np.random.RandomState(seed)


def _data_cfg(cfg):
    return cfg.data if hasattr(cfg, "data") else cfg


def project_points(points: np.ndarray, data_cfg, resolution) -> np.ndarray:
    """(N, C) host points → the (H, W, C + 2) range image ``[x, y, z,
    feat..., depth, valid]`` (numpy float32), through the port's projection
    on the CPU."""
    H, W = resolution
    img = points_to_range_image(
        torch.from_numpy(np.ascontiguousarray(points, np.float32)), H=H, W=W,
        min_depth=data_cfg.min_depth, max_depth=data_cfg.max_depth,
        fov_up=data_cfg.fov_up, fov_down=data_cfg.fov_down,
    )
    return img.numpy()


def host_points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(M, N) membership of the (N, ≥3) points in the (M, 7) boxes, on the
    CPU."""
    return points_in_boxes(
        torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)),
        torch.from_numpy(np.ascontiguousarray(boxes, np.float32)),
    ).numpy()


class NuscDataset:
    """``cfg.data`` names the files (``data_root``, ``pkl_path``, the
    ``split``) and the task; ``infos`` replaces the pickle.  ``seed`` shuffles
    the ``all`` split and seeds ``ds[i]`` (the loader calls
    :meth:`sample` with its own seeds)."""

    def __init__(self, cfg, infos: list[dict] | None = None, seed: int = 0):
        self.cfg = cfg
        data_cfg = _data_cfg(cfg)
        self.data_cfg = data_cfg
        self.task = getattr(data_cfg, "task", None)
        self.data_root = data_cfg.data_root
        self.split = getattr(data_cfg, "split", "train")
        self.class_names = list(getattr(data_cfg, "class_names", ()))
        self.resolution = tuple(data_cfg.resolution)
        self.seed = seed

        if infos is not None:
            self.data = [di for di in infos if di.get("scene_graph", {}).get("valid", True)]
        else:
            self.data = self._load_infos(data_cfg)

        if self.task == "autoregressive_generation":
            self.data_dict = {info["token"]: info for info in self.data}
            self.data = [di for di in self.data
                         if di.get("prev_info", {}).get("valid") and di["prev_info"]["token"] in self.data_dict]

        if self.task == "layout_generation":
            # CLIP features from the cache under ``clip_cache_dir``, or from a
            # ``text_encode_fn`` set on the assigner afterwards
            from .scene_graph import SceneGraphAssigner

            self.scene_graph_assigner = SceneGraphAssigner(
                output_path=getattr(data_cfg, "clip_cache_dir", None), split=self.split)

    # ------------------------------------------------------------------ io

    def _load_infos(self, data_cfg) -> list[dict]:
        """The valid infos of the split's pickles (``pkl_path`` names the
        train one; ``all`` reads train and val and shuffles them)."""
        pkl_path = getattr(data_cfg, "pkl_path", None)
        if pkl_path is None:
            return []
        if self.split != "train" and "train" in pkl_path:
            pkl_path = pkl_path.replace("train", "val")
        paths = [pkl_path.replace("train", s) for s in ("train", "val")] if self.split == "all" else [pkl_path]
        data = []
        for p in paths:
            with open(p, "rb") as f:
                infos = pickle.load(f)
            data += [di for di in infos if di["scene_graph"]["valid"]]
        if self.split == "all":
            random.Random(self.seed).shuffle(data)
        return data

    def __len__(self):
        return len(self.data)

    def _load_points(self, info) -> np.ndarray:
        return np.fromfile(os.path.join(self.data_root, info["lidar_path"]), dtype=np.float32).reshape(-1, 5)[:, :4]

    # ------------------------------------------------------------ transforms

    def project(self, points: np.ndarray) -> dict:
        """Cloud → HWC range-image channels, each pixel masked by its valid
        channel, reflectance over 255."""
        img = project_points(points, self.data_cfg, self.resolution)
        img = img * img[..., 5:6]
        return {
            "xyz": img[..., :3],
            "reflectance": img[..., 3:4] / 255.0,
            "depth": img[..., 4:5],
            "mask": img[..., 5:6],
        }

    def pre_process(self, data_dict: dict) -> dict:
        """The task's conditions: boxes with class ids (``ego`` is class 0),
        their 2D boxes, condition mask and loss-weight map, scaled boxes,
        and for the 13-slot tasks the padded boxes with their encodings."""
        if self.task is None:
            data_dict.pop("points", None)
            return data_dict

        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        fg_encoding = (np.stack([T.encoding_boxes_3d(b[:7], unique_mode=False) for b in gt_boxes[1:]])
                       if len(gt_boxes) > 1 else np.zeros((0, 8), np.float32))
        class_names = ["ego"] + self.class_names
        gt_classes = np.array([class_names.index(n) for n in gt_names], np.float32)
        gt_boxes = np.concatenate([gt_boxes[:, :7], gt_classes[:, None]], axis=1)
        data_dict["gt_boxes"] = gt_boxes

        H, W = self.resolution
        boxes_2d, condition_mask, loss_weight = (
            a.numpy() for a in convert_boxes_to_2d(
                torch.from_numpy(gt_boxes.astype(np.float32)), H=H, W=W,
                fov_up=self.data_cfg.fov_up, fov_down=self.data_cfg.fov_down)
        )
        scaled = T.scale_boxes_3d(gt_boxes.copy()).astype(np.float32)

        if self.task == "layout_generation":
            data_dict.update(gt_boxes_2d=boxes_2d, scaled_gt_boxes=scaled, condition_mask=condition_mask,
                             scene_loss_weight_map=loss_weight)
        elif self.task in ("layout_cond", "autoregressive_generation"):
            b3, b2, fe, valid = T.align_box_num(scaled[1:], boxes_2d[1:], fg_encoding)
            data_dict.update(
                scaled_gt_boxes=b3.astype(np.float32), gt_boxes_2d=b2.astype(np.float32),
                fg_encoding_box=fe.astype(np.float32), is_valid_obj=valid.astype(np.float32),
                condition_mask=condition_mask, scene_loss_weight_map=loss_weight,
            )
        data_dict.pop("points", None)
        return data_dict

    # ------------------------------------------------------- autoregressive

    def get_prev_frame_condition(self, curr_token: str, prev_info: dict, prev_num: int = 1) -> np.ndarray:
        """The frame ``prev_num`` back (as far as the chain goes) warped
        into the current lidar frame: its background by the ego motion, each
        object that is still there replayed at its current box (matched by
        instance id)."""
        prev = self.data_dict[prev_info["token"]]
        for _ in range(prev_num - 1):
            pi = prev.get("prev_info", {})
            if pi.get("valid") and pi["token"] in self.data_dict:
                prev = self.data_dict[pi["token"]]
            else:
                break

        prev_points = T.remove_ego_points(self._load_points(prev), center_radius=2.0)
        prev_boxes = prev["scene_graph"]["keep_box"][1:, :7]
        prev_ids = list(prev["scene_graph"]["keep_agent_instance_inds"][1:])
        curr = self.data_dict[curr_token]
        curr_ids = list(curr["scene_graph"]["keep_agent_instance_inds"][1:])
        curr_boxes = curr["scene_graph"]["keep_box"][1:, :7]

        aligned_to = []
        keep_mask = np.zeros(len(prev_ids), bool)
        for i, gid in enumerate(prev_ids):
            if gid in curr_ids:
                aligned_to.append(curr_boxes[curr_ids.index(gid)])
                keep_mask[i] = True

        bg = prev_points
        fg_aligned, fg_intensity = [], []
        if keep_mask.sum() > 0:
            kept = prev_boxes[keep_mask]
            member = host_points_in_boxes(prev_points, kept)
            bg = prev_points[member.sum(axis=0) == 0]
            for k, box in enumerate(kept):
                pts = prev_points[member[k] > 0]
                fg_intensity.append(pts[:, 3])
                centered = pts[:, :3] - box[:3]
                fg_aligned.append(T._rotate_points_along_z_np(centered[None], -np.array([box[6]]))[0])

        rot, trans = relative_gt_transform(prev, curr)
        bg = bg.copy()
        bg[:, :3] = bg[:, :3] @ rot.T
        bg[:, :3] -= -(rot.T @ np.asarray(trans).reshape(3, 1)).ravel()

        if keep_mask.sum() == 0:
            return bg
        fg = []
        for pts, inten, box in zip(fg_aligned, fg_intensity, aligned_to):
            placed = T._rotate_points_along_z_np(pts[None], np.array([box[6]]))[0] + np.asarray(box[:3])[None]
            fg.append(np.concatenate([placed, inten[:, None]], axis=1))
        return np.concatenate([bg] + fg, axis=0)

    # ------------------------------------------------------------- getitem

    def __getitem__(self, idx: int) -> dict:
        return self.sample(idx, sample_seed(self.seed, 0, idx))

    def sample(self, idx: int, seed: int) -> dict:
        """Sample ``idx``, its random draws from generators seeded ``seed``."""
        return self._sample(idx, SampleDraws(seed))

    def _sample(self, idx: int, draws: SampleDraws) -> dict:
        info = self.data[idx]
        out: dict[str, Any] = {"token": info["token"]}
        train = self.split in ("train", "all")

        if self.task == "autoregressive_generation":
            prev_num = draws.py.randint(1, 5) if train else 1
            cond_points = self.get_prev_frame_condition(info["token"], info["prev_info"], prev_num)
            proj = self.project(cond_points)
            depth = proj["depth"].copy()
            if train:  # train-time depth noise
                depth += draws.np.normal(0, 3, depth.shape)
                depth[depth < 0] = 0
            out["autoregressive_cond"] = np.concatenate([depth, proj["reflectance"]], axis=-1).astype(np.float32)

        points = self._load_points(info)
        if getattr(self.data_cfg, "delete_ground", False):
            seg = np.fromfile(os.path.join(self.data_root, info["gt_segment_path"]), dtype=np.uint8)
            points = T.delete_ground_points(points, seg)

        sg = info["scene_graph"]
        out.update(
            points=points,
            gt_names=sg["keep_box_names"],
            gt_boxes=sg["keep_box"][:, :7],
            gt_box_relationships=sg["keep_box_relationships"],
            gt_fut_trajs=sg["keep_agent_fut_trajs"],
            gt_fut_masks=sg["keep_agent_fut_masks"],
            gt_fut_states=sg["keep_agent_fut_states"],
        )
        out.update(self.project(points))
        out = self.pre_process(out)
        if self.task == "layout_generation":
            # merged flat, so that ``collate_scene_graphs`` sees encoder / decoder / manipulate
            out.update(self.scene_graph_assigner.assign_item(idx, out, rng=draws.np))
        return out

    # -------------------------------------------------------------- collate

    NON_STACK_KEYS = (
        "points", "gt_names", "gt_boxes", "gt_box_relationships", "gt_fut_trajs",
        "gt_fut_masks", "gt_fut_states", "token", "custom_tokens",
    )

    def collate_fn(self, batch: list[dict]) -> dict:
        """Fixed-shape fields stacked as float32, ragged ones in lists."""
        out: dict[str, Any] = {}
        for key in batch[0].keys():
            vals = [b[key] for b in batch]
            out[key] = vals if key in self.NON_STACK_KEYS else np.stack(vals).astype(np.float32)
        out["batch_size"] = len(batch)
        return out
