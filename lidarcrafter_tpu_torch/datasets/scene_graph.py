"""Scene-graph construction, editing and collation (host code, numpy).

Port of the JAX package's ``datasets/scene_graph.py``: the class and
relationship vocabularies, the geometric relationship rules and the
converter step that annotates an info dict with its scene graph
(``build_scene_graph_info``), the (N, 40) box + trajectory packing, the
per-sample ``SceneGraphAssigner`` with its train-time edits (a node removed
for the model to add back, a relationship changed) drawn from an explicit
``np.random.RandomState``, and the flat global-node collation (the
reference's ``"tripltes"`` key kept).  CLIP text features come from the
reference's on-disk cache (``CLIP_{idx:07d}.pkl``) or from a
``text_encode_fn`` (``models/clip_text.py::load_clip_text_encoder``, whose
features on the card are copied to the host here).
"""

from __future__ import annotations

import copy
import os
import pickle
from typing import Callable, Sequence

import numpy as np
import torch

KEEP_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "motorcycle", "bicycle", "pedestrian",
)
RELATIONSHIPS = (
    "left", "right", "front", "behind", "close by",
    "bigger than", "smaller than", "taller than", "shorter than",
)
CHANGED_RELATIONSHIPS = {
    "left": "right", "right": "left", "front": "behind", "behind": "front",
    "bigger than": "smaller than", "smaller than": "bigger than",
    "taller than": "shorter than", "shorter than": "taller than",
    "close by": "close by",
}
CLASSES = ("ego",) + KEEP_NAMES


def cal_box_relationships(subject_box, object_box, ego: bool = False) -> list[str]:
    """The relationships of ``subject_box`` to ``object_box`` ((≥6,)
    metric boxes): front/behind, right/left, close by (< 4 m), and for two
    objects bigger/smaller by volume; taller/shorter by top height (by
    centre height against 0 for the ego)."""
    out = ["front" if subject_box[1] >= object_box[1] else "behind",
           "right" if subject_box[0] >= object_box[0] else "left"]
    distance = np.hypot(subject_box[1] - object_box[1], subject_box[0] - object_box[0])
    if distance < 4:
        out.append("close by")
    if not ego:
        v_s = subject_box[3] * subject_box[4] * subject_box[5]
        v_o = object_box[3] * object_box[4] * object_box[5]
        out.append("bigger than" if v_s >= v_o else "smaller than")
        h_s = subject_box[2] + subject_box[5] / 2
        h_o = object_box[2] + object_box[5] / 2
    else:
        h_s = subject_box[2]
        h_o = 0.0
    out.append("taller than" if h_s >= h_o else "shorter than")
    return out


def mask_boxes_outside_range(boxes: np.ndarray, limit_range, min_num_corners: int = 1) -> np.ndarray:
    """pcdet's corner-count range mask: a box is kept when at least
    ``min_num_corners`` of its corners lie inside ``limit_range``'s x / y
    bounds (``(x0, y0, z0, x1, y1, z1)``)."""
    from ..ops.projection import box_corners_3d

    corners = box_corners_3d(torch.as_tensor(np.asarray(boxes)[:, :7], dtype=torch.float32)).numpy()
    inside = (
        (corners[..., 0] >= limit_range[0]) & (corners[..., 0] <= limit_range[3])
        & (corners[..., 1] >= limit_range[1]) & (corners[..., 1] <= limit_range[4])
    )
    return inside.sum(axis=1) >= min_num_corners


def build_scene_graph_info(
    info: dict,
    keep_names: Sequence[str] = KEEP_NAMES,
    points_range=(-80, -80, -8, 80, 80, 8),
    min_points: int = 30,
) -> dict:
    """One converter step: a copy of ``info`` with its ``scene_graph``
    (``{'valid': False}`` when no box is kept): the kept boxes (in range, of
    a kept class, with more than ``min_points`` points) after an ego box at
    the origin, each object pair's relationships once (subject before
    object) and each object's to the ego, and the agents' futures."""
    mask_range = mask_boxes_outside_range(info["gt_boxes"], points_range)
    gt_names = np.asarray(info["gt_names"])[mask_range]
    num_pts = np.asarray(info["num_lidar_pts"])[mask_range]
    gt_boxes = np.asarray(info["gt_boxes"])[mask_range]
    fut_trajs = np.asarray(info["gt_agent_fut_trajs"])[mask_range]
    fut_masks = np.asarray(info["gt_agent_fut_masks"])[mask_range]
    fut_states = np.asarray(info["gt_agent_fut_states"])[mask_range]
    inst_inds = np.asarray(info["instance_inds"])[mask_range]

    keep = np.array([n in keep_names and p > min_points for n, p in zip(gt_names, num_pts)], bool)
    if keep.sum() == 0:
        info = dict(info)
        info["scene_graph"] = {"valid": False}
        return info

    kb = gt_boxes[keep]
    names = gt_names[keep]
    rels = []
    n = len(names)
    done = np.zeros((n, n), bool)
    for i in range(n):
        for j in range(n):
            if i == j or done[i, j]:
                continue
            for r in cal_box_relationships(kb[i], kb[j]):
                rels.append([i + 1, RELATIONSHIPS.index(r), j + 1])
            done[j, i] = True
    ego_box = np.zeros(9)
    for i in range(n):
        for r in cal_box_relationships(kb[i], ego_box, ego=True):
            rels.append([i + 1, RELATIONSHIPS.index(r), 0])

    info = dict(info)
    info["scene_graph"] = {
        "valid": True,
        "lidar_path": info.get("lidar_path"),
        "keep_box_names": np.insert(names, 0, "ego"),
        "keep_box": np.vstack([ego_box[np.newaxis, :7], kb[:, :7]]),
        "keep_box_relationships": rels,
        "keep_agent_fut_trajs": np.concatenate(
            [np.asarray(info["gt_ego_fut_trajs"])[None], fut_trajs[keep]], axis=0
        ),
        "keep_agent_fut_masks": np.vstack([np.asarray(info["gt_ego_fut_masks"])[None], fut_masks[keep]]),
        "keep_agent_fut_states": np.array([info["gt_ego_fut_state"]] + list(fut_states[keep])),
        "keep_agent_instance_inds": np.insert(inst_inds[keep], 0, -1),
    }
    return info


def pack_boxes_with_trajs(scaled_boxes, gt_fut_trajs, gt_fut_masks) -> np.ndarray:
    """(N, 8) scaled boxes + (N, 6, 2) trajectories + (N, 6) masks → (N, 40):
    20 data columns, then their 20 validity columns (the ego's box columns
    invalid)."""
    n = scaled_boxes.shape[0]
    mask = np.ones((n, 20), bool)
    mask[0, :8] = False
    data = np.concatenate([scaled_boxes[:, :8], gt_fut_trajs.reshape(n, -1)], axis=1)
    mask[:, 8:] = np.repeat(gt_fut_masks[:, :, None], 2, axis=2).reshape(n, -1)
    return np.concatenate([data, mask.astype(data.dtype)], axis=1)


def unique_names(obj_names: list[str]) -> list[str]:
    """Repeated names numbered in order: car, truck, car → car1, truck, car2."""
    out, counts = [], {}
    for obj in obj_names:
        if obj_names.count(obj) > 1:
            counts[obj] = counts.get(obj, 0) + 1
            out.append(f"{obj}{counts[obj]}")
        else:
            out.append(obj)
    return out


def _host(features) -> np.ndarray:
    """A text encoder's features on the host (from the card, a copy)."""
    if isinstance(features, torch.Tensor):
        return features.detach().cpu().numpy()
    return np.asarray(features)


class SceneGraphAssigner:
    """Per-sample graph construction with train-time edits.

    ``text_encode_fn(words: list[str]) -> (len(words), 512)`` gives the CLIP
    text features where the cache (``output_path/split/CLIP_{idx:07d}.pkl``)
    misses; the features it gives are written there.  Pass None to require
    the cache.  Edits draw from ``rng`` (an ``np.random.RandomState``; seed
    0 by default) and apply in the train split only."""

    def __init__(
        self,
        output_path: str | None = None,
        split: str = "train",
        classes: Sequence[str] = CLASSES,
        relationships: Sequence[str] = RELATIONSHIPS,
        text_encode_fn: Callable | None = None,
        with_changes: bool = True,
        rng: np.random.RandomState | None = None,
    ):
        self.output_path = output_path
        self.split = split
        self.classes = {c: i for i, c in enumerate(classes)}
        self.relationships = list(relationships)
        self.rel_to_idx = {r: i for i, r in enumerate(self.relationships)}
        self.text_encode_fn = text_encode_fn
        self.with_changes = with_changes
        self.eval = split != "train"
        self.rng = rng or np.random.RandomState(0)

    # ------------------------------------------------------------- features

    def _clip_path(self, idx: int) -> str | None:
        if self.output_path is None:
            return None
        return os.path.join(self.output_path, self.split, "CLIP_{}.pkl".format(str(idx).zfill(7)))

    def _get_features(self, idx, obj_state_words, rel_words):
        path = self._clip_path(idx)
        if path is not None and os.path.exists(path):
            with open(path, "rb") as f:
                d = pickle.load(f)
            return list(d["instance_feats"]), [d["rel_feats"][w] for w in rel_words]
        if self.text_encode_fn is None:
            raise FileNotFoundError(f"CLIP cache missing for sample {idx} and no text_encode_fn given")
        ins = list(_host(self.text_encode_fn(obj_state_words)))
        rel_feats = _host(self.text_encode_fn(rel_words)) if rel_words else np.zeros((0, 512))
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump({"instance_feats": np.asarray(ins), "rel_feats": dict(zip(rel_words, rel_feats))}, f)
        return ins, list(rel_feats)

    # --------------------------------------------------------------- edits

    def remove_node_and_relationship(self, graph: dict, rng: np.random.RandomState | None = None) -> int:
        """Pop a non-ego node (the 'added' node the model must bring back)
        with its triples, renumbering the rest; returns its index, or -1
        when 100 draws (from ``rng``, else the assigner's) found none."""
        rng = self.rng if rng is None else rng
        excluded = {self.classes["ego"]}
        node_id = -1
        for _ in range(100):
            cand = rng.randint(len(graph["objs"]) - 1)
            if graph["objs"][cand] not in excluded:
                node_id = cand
                break
        if node_id < 0:
            return -1
        graph["objs"].pop(node_id)
        graph["text_feats"].pop(node_id)
        graph["boxes"].pop(node_id)
        for i, (s, p, o) in reversed(list(enumerate(graph["triples"]))):
            if s == node_id or o == node_id:
                graph["triples"].pop(i)
                graph["rel_feats"].pop(i)
                graph["words"].pop(i)
        for t in graph["triples"]:
            if t[0] > node_id:
                t[0] -= 1
            if t[2] > node_id:
                t[2] -= 1
        return node_id

    def modify_relship(self, graph: dict, interpretable: bool = False, rng: np.random.RandomState | None = None):
        """Change one triple's predicate (to its opposite with
        ``interpretable``, else to another drawn at random), rewrite its
        words and mark it ``changed_id`` for the collation to re-encode;
        returns (index, original triple, True), or (-1, None, False) after
        1,000 draws (from ``rng``, else the assigner's)."""
        rng = self.rng if rng is None else rng
        for _ in range(1000):
            idx = rng.randint(len(graph["triples"]))
            s, p, o = graph["triples"][idx]
            if interpretable:
                if p >= len(self.relationships):
                    continue
                new_pred = self.rel_to_idx[CHANGED_RELATIONSHIPS[self.relationships[p]]]
            else:
                new_pred = rng.randint(0, 9)
                if new_pred == p:
                    continue
            if "words" in graph and p < len(self.relationships):
                graph["words"][idx] = graph["words"][idx].replace(self.relationships[p], self.relationships[new_pred])
            graph["changed_id"] = idx
            graph["triples"][idx][1] = new_pred
            return idx, (s, p, o), True
        return -1, None, False

    # --------------------------------------------------------------- build

    def assign_item(self, idx: int, data_dict: dict, rng: np.random.RandomState | None = None) -> dict:
        """One sample's ``{'encoder', 'decoder', 'manipulate', 'scan_id'}``:
        the graph's nodes, triples, packed boxes, relationship words and
        text features; in the train split, a graph of more than two nodes
        gets one edit on its encoder side, drawn from relationship change,
        node addition and none.  The edits draw from ``rng``, else from the
        assigner's own generator (a dataset passes each sample's own, so
        that threads loading samples at once draw in no shared order)."""
        rng = self.rng if rng is None else rng
        boxes = pack_boxes_with_trajs(
            data_dict["scaled_gt_boxes"][:, :8],
            np.asarray(data_dict["gt_fut_trajs"]),
            np.asarray(data_dict["gt_fut_masks"]),
        )
        obj_names = list(data_dict["gt_names"])
        states = list(data_dict["gt_fut_states"])
        uniq = unique_names(obj_names)
        triples = [list(t) for t in data_dict["gt_box_relationships"]]
        rel_words = [f"{uniq[s]} {self.relationships[p]} {uniq[o]}" for s, p, o in triples]
        obj_state_words = [f"{name} will {str(states[i]).lower()}" for i, name in enumerate(obj_names)]
        text_feats, rel_feats = self._get_features(idx, obj_state_words, rel_words)

        encoder = {
            "objs": [self.classes[o] for o in obj_names],
            "triples": triples,
            "boxes": list(boxes),
            "words": list(rel_words),
            "text_feats": text_feats,
            "rel_feats": rel_feats,
        }
        out = {"encoder": encoder, "manipulate": {"type": "none"}, "scan_id": str(idx).zfill(7)}
        out["decoder"] = copy.deepcopy(encoder)

        if self.with_changes and not self.eval and len(encoder["objs"]) > 2:
            kind = ["relationship", "addition", "none"][rng.randint(3)]
            if kind == "addition":
                node_id = self.remove_node_and_relationship(out["encoder"], rng)
                if node_id >= 0:
                    out["manipulate"] = {"type": "addition", "added_node_id": node_id}
            elif kind == "relationship":
                idx2, orig, ok = self.modify_relship(out["encoder"], rng=rng)
                if ok:
                    out["manipulate"] = {"type": "relationship", "original_relship": (idx2, orig)}
        return out


def collate_scene_graphs(batch: list[dict], text_encode_fn: Callable | None = None) -> dict:
    """Flat global-node collation of per-sample ``{'encoder', 'decoder',
    'manipulate'}`` graphs: for each side, ``objs``, ``tripltes`` (node
    indices offset into the flat axis), ``boxes``, ``obj_to_scene``,
    ``triple_to_scene``, ``text_feats`` and ``rel_feats`` as numpy arrays,
    plus the edit lists ``missing_nodes`` / ``manipulated_subs`` /
    ``manipulated_objs``.  ``text_encode_fn`` re-encodes the edited
    relationship (``changed_id``) of a side; without it the edge keeps its
    pre-edit feature."""
    out = {"missing_nodes": [], "manipulated_subs": [], "manipulated_objs": []}
    global_node = 0
    for item in batch:
        man = item["manipulate"]
        if man["type"] == "addition":
            out["missing_nodes"].append(global_node + man["added_node_id"])
        elif man["type"] == "relationship":
            _, (s, p, o) = man["original_relship"]
            out["manipulated_subs"].append(global_node + s)
            out["manipulated_objs"].append(global_node + o)
        global_node += len(item["encoder"]["objs"])

    for side in ("encoder", "decoder"):
        objs, boxes, triples = [], [], []
        obj_to_scene, triple_to_scene = [], []
        text_feats, rel_feats = [], []
        offset = 0
        for scene_id, item in enumerate(batch):
            g = item[side]
            objs.extend(g["objs"])
            boxes.extend(g["boxes"])
            text_feats.extend(g["text_feats"])
            if text_encode_fn is not None and "changed_id" in g:
                cid = g["changed_id"]
                g = dict(g, rel_feats=list(g["rel_feats"]))
                g["rel_feats"][cid] = np.squeeze(_host(text_encode_fn([g["words"][cid]])))
            rel_feats.extend(g["rel_feats"])
            for s, p, o in g["triples"]:
                triples.append([s + offset, p, o + offset])
            obj_to_scene.extend([scene_id] * len(g["objs"]))
            triple_to_scene.extend([scene_id] * len(g["triples"]))
            offset += len(g["objs"])
        out[side] = {
            "objs": np.asarray(objs, np.int64),
            "tripltes": np.asarray(triples, np.int64).reshape(-1, 3),  # the reference's key
            "boxes": np.asarray(boxes, np.float32),
            "obj_to_scene": np.asarray(obj_to_scene, np.int64),
            "triple_to_scene": np.asarray(triple_to_scene, np.int64),
            "text_feats": np.asarray(text_feats, np.float32),
            "rel_feats": np.asarray(rel_feats, np.float32),
        }
    return out
