"""Synthetic data for smoke runs and ``chip_smoke.py``, since the repo
holds no nuScenes scenes.

:func:`banded_range_image_batch` is the port of the JAX package's
``utils/synthetic.py`` (the distribution that its
``bench.py::bench_solver_cert`` trains on), drawn from a
``torch.Generator`` instead of a JAX key.  :func:`synthetic_scene_graphs`
and :func:`synthetic_object_boxes` are the inputs of the layout and object
branches: boxes drawn from a numpy seed, the scene graph's triples derived
with the ported relationship rules (every object pair once, every object to
the ego, so the edge count is the converter's O(n²)), and seeded unit
vectors in place of the CLIP text features.  :func:`synthetic_object_points`
adds the object branch's training target: points drawn uniformly in each
box, normalised to the box frame with ``norm_fg_points`` as the object
dataset does.  :func:`write_nuscenes_tree` writes a small nuScenes-format
tree (clouds, lidarseg labels, info pickles, a GT database and a CLIP
feature cache) that the datasets of ``datasets/`` read like the real one.
"""

from __future__ import annotations

import math
import os
import pickle
import zlib

import numpy as np
import torch

from ..datasets.scene_graph import (
    CLASSES, KEEP_NAMES, RELATIONSHIPS, SceneGraphAssigner, build_scene_graph_info, cal_box_relationships,
    collate_scene_graphs, pack_boxes_with_trajs,
)
from ..datasets.transforms import _rotate_points_along_z_np, norm_fg_points, object_encoding_boxes_3d, scale_boxes_3d

CLIP_DIM = 512


def _unit_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    v = rng.standard_normal((n, CLIP_DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _scene_boxes(num_scenes: int, n: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per scene, ``n`` metric boxes (x, y, z, w, h, l, yaw) within 50 m of
    the ego, with pedestrian-to-truck sizes, and their classes 1..8 (0 is
    the ego)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_scenes):
        boxes = np.concatenate([
            rng.uniform(-50, 50, (n, 2)), rng.uniform(-2, 1, (n, 1)),
            rng.uniform([0.6, 0.6, 1.0], [3.0, 12.0, 4.0], (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
        ], axis=1)
        out.append((boxes, rng.integers(1, len(CLASSES), n)))
    return out


def synthetic_scene_graphs(num_scenes: int, objs_per_scene: int, seed: int = 0) -> dict:
    """A collated batch of ``num_scenes`` scene graphs (ego + ``objs_per_scene``
    objects each), as ``collate_scene_graphs`` gives it: decoder and encoder
    sides alike, no edits.  In every second scene the last object has no
    triple, as a node the converter left unrelated, so the pooling sees
    nodes without messages."""
    rng = np.random.default_rng([seed, 1])  # trajectories and text features
    items = []
    for scene, (boxes, classes) in enumerate(_scene_boxes(num_scenes, objs_per_scene, seed)):
        n = objs_per_scene
        isolated = n if scene % 2 else -1  # node index of the unrelated object
        triples = []
        for i in range(n):
            for j in range(i + 1, n):
                if isolated not in (i + 1, j + 1):
                    triples += [[i + 1, RELATIONSHIPS.index(r), j + 1] for r in cal_box_relationships(boxes[i], boxes[j])]
        for i in range(n):
            if i + 1 != isolated:
                triples += [[i + 1, RELATIONSHIPS.index(r), 0]
                            for r in cal_box_relationships(boxes[i], np.zeros(9), ego=True)]
        metric = np.vstack([np.zeros((1, 7)), boxes])
        trajs = np.cumsum(rng.normal(0, 0.5, (n + 1, 6, 2)), axis=1)
        graph = {
            "objs": [0] + classes.tolist(),
            "triples": triples,
            "boxes": list(pack_boxes_with_trajs(scale_boxes_3d(metric), trajs, np.ones((n + 1, 6)))),
            "text_feats": list(_unit_rows(rng, n + 1)),
            "rel_feats": list(_unit_rows(rng, len(triples))),
        }
        items.append({"encoder": graph, "decoder": graph, "manipulate": {"type": "none"}})
    return collate_scene_graphs(items)


def synthetic_object_boxes(num_scenes: int, objs_per_scene: int, seed: int = 0) -> dict:
    """The object branch's request for the objects of the scenes that
    ``synthetic_scene_graphs`` draws from the same arguments:
    ``fg_encoding_box`` (n, 6) from ``object_encoding_boxes_3d``,
    ``fg_class`` (n,) in 0..7 and a (9, 512) ``fg_text_features`` table;
    numpy arrays."""
    boxes, classes = (np.concatenate(a) for a in zip(*_scene_boxes(num_scenes, objs_per_scene, seed)))
    return {
        "fg_encoding_box": np.stack([object_encoding_boxes_3d(b) for b in boxes]),
        "fg_class": (classes - 1).astype(np.int64),
        "fg_text_features": _unit_rows(np.random.default_rng([seed, 2]), len(CLASSES)),
    }


def synthetic_object_points(num_scenes: int, objs_per_scene: int, num_points: int = 1024, seed: int = 0) -> dict:
    """:func:`synthetic_object_boxes` of the same arguments plus
    ``fg_points`` (n, num_points, 4) float32: per object, points uniform in
    its box with intensities uniform in [0, 255], centre-relative in the
    scene frame (rotated by the yaw), then normalised with
    ``norm_fg_points``."""
    boxes = np.concatenate([b for b, _ in _scene_boxes(num_scenes, objs_per_scene, seed)])
    rng = np.random.default_rng([seed, 3])
    n = len(boxes)
    local = rng.uniform(-1, 1, (n, num_points, 3)) * boxes[:, None, 3:6] / 2
    points = np.concatenate([local, rng.uniform(0, 255, (n, num_points, 1))], axis=-1)
    points = _rotate_points_along_z_np(points, boxes[:, 6])
    fg_points = np.stack([norm_fg_points(p, b) for p, b in zip(points, boxes)]).astype(np.float32)
    return dict(synthetic_object_boxes(num_scenes, objs_per_scene, seed), fg_points=fg_points)


def banded_range_image_batch(
    batch: int,
    H: int,
    W: int,
    generator: torch.Generator | None = None,
    freq_levels: int = 4,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """(B, H, W, 2) banded sinusoidal depth + correlated reflectance, both
    in [-1, 1]: per-sample random phase and integer frequency
    (1..freq_levels) over the azimuth axis, depth attenuated toward the
    lower rows, reflectance = 0.5·depth + noise.  Draws phase, frequency,
    then noise from ``generator``."""
    kw = dict(generator=generator, device=device)
    phase = torch.rand((batch, 1, 1), **kw) * 2 * math.pi
    freq = 1.0 + torch.randint(0, freq_levels, (batch, 1, 1), **kw).float()
    cols = torch.arange(W, device=device)[None, None, :] / W
    rows = torch.arange(H, device=device)[None, :, None] / H
    depth = 0.6 * torch.sin(2 * math.pi * freq * cols + phase) * (1 - 0.5 * rows)
    refl = torch.clamp(0.5 * depth + 0.1 * torch.randn((batch, H, W), **kw), -1, 1)
    return torch.stack([depth, refl], dim=-1)


# ------------------------------------------------------- nuScenes-format files

STATES = ("Stop", "Go straight", "Turn left", "Turn right")
SPLITS = ("train", "val")


def text_features(words) -> np.ndarray:
    """A stand-in CLIP text encoder: one unit vector per word, seeded by the
    word's CRC, so every run and every package gets the same features."""
    return np.stack([_unit_rows(np.random.default_rng(zlib.crc32(w.encode())), 1)[0] for w in words])


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _cloud(rng: np.random.Generator, num_points: int, boxes: np.ndarray, inside: np.ndarray) -> np.ndarray:
    """(num_points, 5) float32: ``inside[k]`` points well inside box k (in
    its central 80%), the rest at uniform azimuths, elevations in the
    field of view (−30°..10°) and depths in [2, 70) m; intensities uniform
    in [0, 255); the fifth column 0."""
    fg = []
    for box, k in zip(boxes, inside):
        local = rng.uniform(-0.4, 0.4, (k, 3)) * box[3:6]
        fg.append(_rotate_points_along_z_np(local[None], np.array([-box[6]]))[0] + box[:3])
    n_bg = num_points - int(inside.sum())
    az = rng.uniform(-np.pi, np.pi, n_bg)
    el = np.radians(rng.uniform(-30.0, 10.0, n_bg))
    r = rng.uniform(2.0, 70.0, n_bg)
    bg = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], axis=1)
    xyz = np.concatenate(fg + [bg])
    return np.concatenate([xyz, rng.uniform(0, 255, (len(xyz), 1)), np.zeros((len(xyz), 1))], axis=1).astype(np.float32)


def write_nuscenes_tree(root, num_scenes: int = 2, frames: int = 4, num_objects: int = 6, num_points: int = 35000,
                        seed: int = 0) -> dict:
    """Write a nuScenes-format tree under ``root`` and return its paths:
    ``data_root``, ``pkl_path`` (the train info pickle; the val one beside
    it), ``db_path`` (the GT database) and ``clip_cache_dir``.

    Each split holds ``num_scenes`` scenes of ``frames`` frames.  The ego
    drives 1.5 m a frame and turns 0.02 rad; ``num_objects`` boxes stand
    still in the world (the last appears only from a scene's second frame),
    each holding 60–200 points of a frame's ``num_points``.  Every frame has
    its cloud (``samples/*.bin``, N×5 float32), lidarseg labels
    (``lidarseg/*.bin``, uint8, 24 / 26 ground on about a quarter of the
    points), its calibration chain and a ``prev_info`` to the frame before
    (with ``sensor2lidar_*``), and the scene graph of the port's
    ``build_scene_graph_info``.  The GT database holds every object of the
    train split's first frames, box-centred, ``num_points_in_gt`` as
    written (below 50 for some, so the object dataset resamples).  The CLIP
    cache holds :func:`text_features` of each valid sample's words, written
    by ``SceneGraphAssigner``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "lidarseg"), exist_ok=True)
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    os.makedirs(os.path.join(root, "infos"), exist_ok=True)
    paths = {"data_root": str(root), "pkl_path": os.path.join(root, "infos", "nuscenes_infos_train.pkl"),
             "db_path": os.path.join(root, "infos", "nuscenes_dbinfos.pkl"),
             "clip_cache_dir": os.path.join(root, "clips")}
    db: dict = {}
    lidar2ego = (np.eye(3), np.array([0.94, 0.0, 1.84]))
    for split in SPLITS:
        infos = []
        for scene in range(num_scenes):
            n = num_objects
            world_boxes = np.concatenate([
                rng.uniform(-35, 35, (n, 2)), rng.uniform(-1.5, 0.5, (n, 1)),
                rng.uniform([3.5, 1.6, 1.4], [6.0, 2.6, 3.0], (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
            ], axis=1)
            names = rng.choice(KEEP_NAMES, n)
            states = rng.choice(STATES, n)
            trajs = np.cumsum(rng.normal(0, 0.5, (n, 6, 2)), axis=1)
            prev = None
            for f in range(frames):
                token = f"{split}_{scene:02d}_{f:02d}"
                yaw = 0.02 * f
                e2g_r, e2g_t = _yaw_matrix(yaw), np.array([1.5 * f, 0.0, 0.0])
                # world → lidar: inverse of lidar→ego→world
                l2w_r = e2g_r @ lidar2ego[0]
                l2w_t = e2g_r @ lidar2ego[1] + e2g_t
                present = np.arange(n) if f else np.arange(n - 1)
                boxes = world_boxes[present].copy()
                boxes[:, :3] = (boxes[:, :3] - l2w_t) @ l2w_r
                boxes[:, 6] = boxes[:, 6] - yaw
                inside = rng.integers(60, 200, len(present))
                cloud = _cloud(rng, num_points, boxes, inside)
                lidar_path = os.path.join("samples", f"{token}.bin")
                cloud.tofile(os.path.join(root, lidar_path))
                seg = rng.integers(0, 32, len(cloud)).astype(np.uint8)
                seg[rng.random(len(cloud)) < 0.25] = rng.choice(np.array([24, 26], np.uint8))
                seg_path = os.path.join("lidarseg", f"{token}.bin")
                seg.tofile(os.path.join(root, seg_path))
                info = {
                    "token": token, "lidar_path": lidar_path, "gt_segment_path": seg_path,
                    "lidar2ego_rotation": lidar2ego[0], "lidar2ego_translation": lidar2ego[1],
                    "ego2global_rotation": e2g_r, "ego2global_translation": e2g_t,
                    "gt_boxes": boxes, "gt_names": names[present], "num_lidar_pts": inside,
                    "gt_agent_fut_trajs": trajs[present], "gt_agent_fut_masks": np.ones((len(present), 6)),
                    "gt_agent_fut_states": states[present], "instance_inds": present,
                    "gt_ego_fut_trajs": np.cumsum(np.full((6, 2), [1.5, 0.0]), axis=0),
                    "gt_ego_fut_masks": np.ones(6), "gt_ego_fut_state": "Go straight",
                    "prev_info": {"valid": False, "token": None},
                }
                if prev is not None:
                    rot = _yaw_matrix(-0.02)  # the previous lidar frame seen from this one
                    info["prev_info"] = {"valid": True, "token": prev["token"], "sensor2lidar_rotation": rot,
                                         "sensor2lidar_translation": np.array([-1.5, 0.0, 0.0])}
                infos.append(build_scene_graph_info(info))
                if split == "train" and f == 0:
                    for k, box in enumerate(boxes):
                        member = slice(int(inside[:k].sum()), int(inside[:k + 1].sum()))
                        pts = cloud[member].copy()
                        pts[:, :3] -= box[:3]
                        path = os.path.join("gt_database", f"{token}_{names[k]}_{k}.bin")
                        pts.tofile(os.path.join(root, path))
                        num = int(inside[k]) if k % 3 else 40  # every third object too sparse to train
                        db.setdefault(str(names[k]), []).append(
                            {"box3d_lidar": box, "num_points_in_gt": num, "path": path})
                prev = info
        with open(os.path.join(root, "infos", f"nuscenes_infos_{split}.pkl"), "wb") as fh:
            pickle.dump(infos, fh)
        assigner = SceneGraphAssigner(output_path=paths["clip_cache_dir"], split=split, text_encode_fn=text_features)
        for idx, info in enumerate(i for i in infos if i["scene_graph"]["valid"]):
            sg = info["scene_graph"]
            assigner.assign_item(idx, {
                "scaled_gt_boxes": scale_boxes_3d(sg["keep_box"]), "gt_fut_trajs": sg["keep_agent_fut_trajs"],
                "gt_fut_masks": sg["keep_agent_fut_masks"], "gt_names": sg["keep_box_names"],
                "gt_fut_states": sg["keep_agent_fut_states"], "gt_box_relationships": sg["keep_box_relationships"]})
    with open(paths["db_path"], "wb") as fh:
        pickle.dump(db, fh)
    return paths


def point_config_at_tree(cfg, paths: dict, split: str = "train"):
    """``cfg`` reading the tree of :func:`write_nuscenes_tree`: its data
    root, CLIP cache and ``split``, and its info pickle (the GT database for
    the object branch)."""
    cfg.data.data_root = paths["data_root"]
    cfg.data.clip_cache_dir = paths["clip_cache_dir"]
    cfg.data.split = split
    cfg.data.pkl_path = paths["db_path"] if cfg.data.task == "object_generation" else paths["pkl_path"]
    return cfg
