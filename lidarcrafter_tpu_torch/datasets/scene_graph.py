"""Scene-graph relationships, box packing and collation (host code, numpy).

Port of the JAX package's ``datasets/scene_graph.py`` parts that the layout
branch serves with: the class and relationship vocabularies, the geometric
relationship rules, the (N, 40) box + trajectory packing and the flat
global-node collation (the reference's ``"tripltes"`` key kept).  The
per-sample ``SceneGraphAssigner`` is not ported: it needs the CLIP text
tower's weights and BPE table.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

KEEP_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "motorcycle", "bicycle", "pedestrian",
)
RELATIONSHIPS = (
    "left", "right", "front", "behind", "close by",
    "bigger than", "smaller than", "taller than", "shorter than",
)
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
                g["rel_feats"][cid] = np.squeeze(np.asarray(text_encode_fn([g["words"][cid]])))
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
