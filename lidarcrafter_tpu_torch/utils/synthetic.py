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
dataset does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..datasets.scene_graph import (
    CLASSES, RELATIONSHIPS, cal_box_relationships, collate_scene_graphs, pack_boxes_with_trajs,
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
