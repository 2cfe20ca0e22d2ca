"""3D detection evaluation over generated scenes.

Port of the JAX package's ``metrics/detection_eval.py``:

- box recall at rotated-3D-IoU thresholds (pcdet's ``recall_rcnn_*``: a
  ground-truth box counts when any detection overlaps it that much, class
  agnostic), the IoUs on ``device``;
- the nuScenes-protocol AP: per class and centre-distance threshold, greedy
  matching in descending score on the BEV centre distance, 101-point
  interpolated precision, normalised over recall and precision above 0.1
  (the devkit's ``accumulate`` / ``calc_ap``), on the host as the devkit
  does it.

Annotations follow pcdet: a detection is ``{"boxes_lidar": (N, 7), "score":
(N,), "name": (N,)}``, a ground truth ``{"gt_boxes": (M, 7), "name": (M,)}``,
one dict a sample, the two lists aligned.
"""

from __future__ import annotations

import pickle
from collections import defaultdict

import numpy as np
import torch

from ..ops.iou3d import boxes_iou3d

DEFAULT_RECALL_THRESHOLDS = (0.3, 0.5, 0.7)
DEFAULT_DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)


def load_gt_infos(path) -> dict:
    """An info pickle → token → {"gt_boxes": (M, 7), "gt_names": (M,)}: the
    converter's nuScenes infos (``{"infos": [...]}``) or a plain list of
    ``{"token", "gt_boxes", "gt_names"}`` dicts."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict) and "infos" in obj:
        obj = obj["infos"]
    out = {}
    for info in obj:
        token = info.get("token") or info.get("sample_token")
        boxes = np.asarray(info["gt_boxes"], np.float32)
        boxes = boxes.reshape(-1, boxes.shape[-1] if boxes.ndim == 2 else 7)
        out[str(token)] = {"gt_boxes": boxes[:, :7], "gt_names": np.asarray(info.get("gt_names", info.get("names")))}
    return out


def match_token(stem: str, tokens) -> str | None:
    """A generated file's stem → its sample token: the last '_'-separated
    chunk of the stem, else the whole stem."""
    cand = stem.split(".")[0].split("_")[-1]
    if cand in tokens:
        return cand
    return stem if stem in tokens else None


def _as_boxes7(arr) -> np.ndarray:
    """A box array as (N, 7): 9-column boxes lose their velocities, a flat
    (7,) / (9,) box is one row."""
    a = np.asarray(arr, np.float32)
    if a.size == 0:
        return a.reshape(0, 7)
    if a.ndim == 1:
        a = a.reshape(1, -1)
    return a.reshape(len(a), -1)[:, :7]


def box_recall_counts(det_boxes, gt_boxes, thresholds=DEFAULT_RECALL_THRESHOLDS,
                      device: str | torch.device = "cpu") -> dict:
    """One sample's recall tallies (``recall_rcnn_{t}``, ``gt_num``)."""
    det7, gt7 = _as_boxes7(det_boxes), _as_boxes7(gt_boxes)
    out = {f"recall_rcnn_{t}": 0 for t in thresholds}
    out["gt_num"] = int(len(gt7))
    if len(gt7) == 0 or len(det7) == 0:
        return out
    best = boxes_iou3d(torch.as_tensor(det7, device=device), torch.as_tensor(gt7, device=device)).amax(0).cpu().numpy()
    for t in thresholds:
        out[f"recall_rcnn_{t}"] = int((best >= t).sum())
    return out


def _accumulate_class(det_annos, gt_annos, class_name: str, dist_th: float):
    """Greedy centre-distance matching of one (class, threshold): every
    prediction of the class, in descending score, takes the nearest
    unmatched ground truth of its sample within ``dist_th``.  Returns
    (scores in that order, true-positive flags, ground-truth count)."""
    preds = []
    for i, det in enumerate(det_annos):
        boxes = _as_boxes7(det["boxes_lidar"])
        scores_i = np.asarray(det["score"], np.float64).reshape(-1)
        for j in np.flatnonzero(np.asarray(det["name"]) == class_name):
            preds.append((float(scores_i[j]), i, float(boxes[j][0]), float(boxes[j][1])))
    gts, n_gt = {}, 0
    for i, gt in enumerate(gt_annos):
        sel = np.flatnonzero(np.asarray(gt["name"]) == class_name)
        boxes = _as_boxes7(gt["gt_boxes"])
        gts[i] = [boxes[j][:2].astype(np.float64) for j in sel]
        n_gt += len(sel)
    preds.sort(key=lambda p: -p[0])
    taken: dict[int, set] = defaultdict(set)
    scores = np.array([p[0] for p in preds], np.float64)
    tp = np.zeros(len(preds), bool)
    for k, (_, i, x, y) in enumerate(preds):
        best_d, best_j = np.inf, None
        for j, c in enumerate(gts.get(i, [])):
            if j in taken[i]:
                continue
            d = float(np.hypot(c[0] - x, c[1] - y))
            if d < best_d:
                best_d, best_j = d, j
        if best_j is not None and best_d < dist_th:
            tp[k] = True
            taken[i].add(best_j)
    return scores, tp, n_gt


def calc_ap(tp: np.ndarray, n_gt: int, min_recall: float = 0.1, min_precision: float = 0.1) -> float:
    """101-point interpolated AP, normalised as the nuScenes devkit's
    ``calc_ap``; ``tp`` in descending score."""
    if n_gt == 0 or len(tp) == 0:
        return 0.0
    tps = np.cumsum(tp).astype(np.float64)
    fps = np.cumsum(~tp).astype(np.float64)
    prec = tps / (tps + fps)
    rec = tps / n_gt
    prec_interp = np.interp(np.linspace(0.0, 1.0, 101), rec, prec, right=0.0)
    prec_interp = prec_interp[int(round(100 * min_recall)) + 1:]
    prec_interp = np.maximum(prec_interp - min_precision, 0.0)
    return float(np.mean(prec_interp)) / (1.0 - min_precision)


def evaluate_detections(det_annos, gt_annos, class_names, dist_thresholds=DEFAULT_DIST_THRESHOLDS,
                        recall_thresholds=DEFAULT_RECALL_THRESHOLDS, device: str | torch.device = "cpu") -> dict:
    """Recall, per-class AP and mAP, and the mean count of predictions, in
    the JAX package's (and pcdet's) result keys."""
    assert len(det_annos) == len(gt_annos)
    tallies = {f"recall_rcnn_{t}": 0 for t in recall_thresholds}
    tallies["gt_num"] = 0
    for det, gt in zip(det_annos, gt_annos):
        for k, v in box_recall_counts(det["boxes_lidar"], gt["gt_boxes"], recall_thresholds, device).items():
            tallies[k] += v
    result = {}
    denom = max(tallies["gt_num"], 1)
    for t in recall_thresholds:
        result[f"recall/rcnn_{t}"] = tallies[f"recall_rcnn_{t}"] / denom
    result["gt_num"] = tallies["gt_num"]
    ap_table = {}
    for cls in class_names:
        per_th = {}
        for d in dist_thresholds:
            _, tp, n_gt = _accumulate_class(det_annos, gt_annos, cls, d)
            per_th[f"dist_{d}"] = calc_ap(tp, n_gt)
        per_th["mean"] = float(np.mean(list(per_th.values()))) if per_th else 0.0
        ap_table[cls] = per_th
    result["ap"] = ap_table
    aps = [v["mean"] for v in ap_table.values()]
    result["mAP"] = float(np.mean(aps)) if aps else 0.0
    result["avg_pred_objects"] = sum(len(np.asarray(d["name"])) for d in det_annos) / max(len(det_annos), 1)
    return result
