"""Object-level metrics: CGF, RGF and DCF.

Port of the JAX package's ``metrics/fg_object.py``:

- **CGF**: a PointMLP's classification accuracy with precision / recall /
  F1, overall and binned by the objects' point counts (pandas ``cut`` and
  sklearn's ``precision_recall_fscore_support`` semantics, in numpy);
- **RGF**: GLENet's box uncertainty over 10 folds × 30 Monte-Carlo passes,
  the per-object variance and overlap binned by point count;
- **DCF**: the detector's mean confidence per class.

The networks run on the device of their inputs (the apply functions the
caller builds); the bookkeeping is numpy on the host, as in the JAX
package.  GLENet's normal draws are explicit: ``draw(fold, pass, batch,
shape, device)``, by default a CPU ``torch.Generator`` seeded per (fold,
pass), so the card and the CPU draw the same numbers; tests pass the JAX
package's draws.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Sequence

import numpy as np
import torch

CGF_BINS = (0, 100, 200, 300, 400, 500, np.inf)
CGF_LABELS = ("<100", "100-200", "200-300", "300-400", "400-500", ">500")
RGF_BINS = (0, 150, 300, np.inf)
RGF_LABELS = ("<150", "150-300", ">300")
BOX_CLAMP = 200.0  # decoded boxes are clamped to ±200 before the overlap


def _bin_labels(values, bins, labels):
    """``pd.cut(include_lowest=True)``: bins (lo, hi], the first closed."""
    values = np.asarray(values, float)
    out = np.full(len(values), -1)
    for i, (lo, hi) in enumerate(zip(bins[:-1], bins[1:])):
        if i == 0:
            mask = (values >= lo) & (values <= hi)
        else:
            mask = (values > lo) & (values <= hi)
        out[np.where(mask & (out == -1))[0]] = i
    return out


def precision_recall_f1(y_true, y_pred, num_classes):
    """sklearn ``precision_recall_fscore_support(zero_division=0)``."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    p, r, f, s = [], [], [], []
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        rec = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
        p.append(prec)
        r.append(rec)
        f.append(f1)
        s.append(int(np.sum(y_true == c)))
    return np.array(p), np.array(r), np.array(f), np.array(s)


def compute_classification_metrics_fixed_bins(result_dict: dict, bins=CGF_BINS, labels=CGF_LABELS) -> dict:
    """Accuracy and per-class precision / recall / F1 / support, overall
    and per point-count bin."""
    class_names = list(result_dict["class_names"])
    y_true = np.asarray(result_dict["test_true"])
    y_pred = np.asarray(result_dict["test_pred"])
    pts = np.asarray(result_dict["num_points_in_gt"])

    def stats(yt, yp):
        acc = float(np.mean(yt == yp)) if len(yt) else 0.0
        p, r, f, s = precision_recall_f1(yt, yp, len(class_names))
        per_class = {
            name: {"precision": float(p[i]), "recall": float(r[i]), "f1-score": float(f[i]), "support": int(s[i])}
            for i, name in enumerate(class_names)
        }
        return {"accuracy": acc, "per_class": per_class}

    out = {"overall": stats(y_true, y_pred), "partitions": {}}
    bin_idx = _bin_labels(pts, bins, labels)
    for i, lbl in enumerate(labels):
        mask = bin_idx == i
        if not mask.any():
            continue
        out["partitions"][lbl] = stats(y_true[mask], y_pred[mask])
    return out


def compute_cgf(
    classifier_apply: Callable,
    object_clouds: Sequence[np.ndarray],
    labels: Sequence[int],
    num_points_in_gt: Sequence[int],
    class_names: Sequence[str],
    batch_size: int = 32,
    device: str | torch.device = "cuda",
) -> dict:
    """CGF: ``classifier_apply(points (B, N, 3) on device) -> (B,
    num_classes) logits`` (e.g. :func:`pointmlp_logits`) over the
    box-normalised object clouds, in batches of ``batch_size``."""
    preds = []
    clouds = np.stack([np.asarray(c)[:, :3] for c in object_clouds]).astype(np.float32)
    for i in range(0, len(clouds), batch_size):
        logits = classifier_apply(torch.as_tensor(clouds[i : i + batch_size], device=device))
        preds.extend(logits.argmax(dim=1).cpu().tolist())
    result_dict = {
        "class_names": list(class_names),
        "test_true": np.asarray(labels),
        "test_pred": np.asarray(preds),
        "num_points_in_gt": np.asarray(num_points_in_gt),
    }
    return compute_classification_metrics_fixed_bins(result_dict)


def pointmlp_logits(model) -> Callable:
    """``apply(points) -> logits`` of a PointMLP on its running statistics."""
    model.eval()

    @torch.inference_mode()
    def apply(points):
        return model(points)

    return apply


def compute_regression_metrics_fixed_bins(result_json: dict, bins=RGF_BINS, labels=RGF_LABELS) -> dict:
    """Mean variance and overlap, overall and per point-count bin, of
    ``{key: {variance, overlap, pointnum}}``."""
    recs = list(result_json.values())
    variance = np.asarray([np.asarray(r["variance"], float) for r in recs])
    overlap = np.asarray([r["overlap"] for r in recs], float)
    pointnum = np.asarray([r["pointnum"] for r in recs], float)

    out = {
        "overall": {"variance": np.mean(variance, axis=0).tolist(), "overlap": float(np.mean(overlap))},
        "partitions": {},
    }
    bin_idx = _bin_labels(pointnum, bins, labels)
    for i, lbl in enumerate(labels):
        mask = bin_idx == i
        if not mask.any():
            continue
        out["partitions"][lbl] = {
            "variance": np.mean(variance[mask], axis=0).tolist(),
            "overlap": float(np.mean(overlap[mask])),
        }
    return out


def compute_rgf(per_object_records: dict) -> dict:
    """RGF of per-object ``{variance, overlap, pointnum}`` records."""
    return compute_regression_metrics_fixed_bins(per_object_records)


# ----------------------------------------------------------- RGF's folds


def _limit_period(val, offset, period):
    return val - np.floor(val / period + offset) * period


def glenet_apply(model) -> Callable:
    """``apply(batch, eps) -> (B, 9)`` boxes of a GLENet in eval mode."""
    model.eval()

    @torch.inference_mode()
    def apply(batch, eps):
        return model(batch, eps=eps)

    return apply


def glenet_pass_records(apply_fn: Callable, dataset, draw: Callable, batch_size: int = 64,
                        device: str | torch.device = "cuda") -> dict:
    """One Monte-Carlo pass over a fold's validation dataset → ``{key:
    {pred_box, gt_box, overlap}}``.

    ``apply_fn(batch, eps) -> (B, 9)`` encoded boxes (:func:`glenet_apply`),
    ``draw(batch_index, batch_len)`` the pass's normal draw of that batch.
    Boxes are decoded before they are recorded, and ``overlap`` is the 3D
    IoU of each decoded ground-truth and predicted box, both clamped to
    ±200 (``ops/iou3d.py::paired_boxes_iou3d``, on ``device``)."""
    from ..datasets.object_uncertainty import decode_boxes
    from ..ops.iou3d import paired_boxes_iou3d

    out = {}
    for bi, batch in enumerate(dataset.batches(batch_size)):
        frame_ids = batch.pop("frame_id")
        bd = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        pred = apply_fn(bd, draw(bi, len(frame_ids))).cpu().numpy()
        pred_dec = decode_boxes(pred)
        gt_dec = decode_boxes(batch["gt_boxes"])
        boxes = [torch.as_tensor(np.clip(b[:, :7], -BOX_CLAMP, BOX_CLAMP), device=device) for b in (gt_dec, pred_dec)]
        ov = paired_boxes_iou3d(*boxes).cpu().numpy()
        for i in range(len(frame_ids)):
            key = f"{frame_ids[i]}_{frame_ids[i]}"
            out[key] = {"pred_box": pred_dec[i].tolist(), "gt_box": gt_dec[i, :7].tolist(), "overlap": float(ov[i])}
    return out


def single_fold_data(result_data_list, used_infos, val_idx):
    """One fold's passes aggregated: per validation object, the pred boxes
    of every pass with the yaw turned into ``sin(limit_period(yaw −
    gt_yaw, 0, 2π))``, the variance of the 7 box parameters over the
    passes, and the mean overlap.  Returns (keys, pointnums, overlaps,
    variances)."""
    key_l, pointnum_l, overlap_l, variance_l = [], [], [], []
    car_info = [used_infos[idx] for idx in val_idx]
    for index in range(len(car_info)):
        info = car_info[index]
        key = f"{val_idx[index]}_{val_idx[index]}"
        if key not in result_data_list[0]:
            continue
        pred_boxes = np.array([r[key]["pred_box"] for r in result_data_list])  # (passes, 9)
        pred_box_overlap = [r[key]["overlap"] for r in result_data_list]
        gt_box_angle = result_data_list[0][key]["gt_box"][6]
        pred_boxes[:, 6] = _limit_period(pred_boxes[:, 6] - gt_box_angle, 0, 2 * np.pi)
        pred_boxes[:, 6] = np.sin(pred_boxes[:, 6])
        key_l.append(key)
        pointnum_l.append(info["num_points_in_gt"])
        variance_l.append(np.var(pred_boxes[:, :7], axis=0))
        overlap_l.append(np.mean(pred_box_overlap))
    return key_l, pointnum_l, overlap_l, variance_l


def seeded_draws(seed: int = 7) -> Callable:
    """The default RGF draw: ``draw(fold, pass, batch, shape, device)``
    from a CPU ``torch.Generator`` seeded with ``seed`` · 10⁶ + fold · 10³ +
    pass at a pass's first batch (so the batches of a pass draw from one
    stream), moved to ``device``."""
    state = {}

    def draw(fold, pass_idx, batch, shape, device):
        if batch == 0:
            state["g"] = torch.Generator().manual_seed(seed * 1_000_000 + fold * 1_000 + pass_idx)
        return torch.randn(shape, generator=state["g"]).to(device)

    return draw


def compute_rgf_folds(infos, build_fold_apply: Callable, draw: Callable | None = None, num_passes: int = 30,
                      num_folds: int = 10, batch_size: int = 64, text_feat=None, point_dims: int = 4,
                      latent_size: int = 8, device: str | torch.device = "cuda") -> dict:
    """RGF over ``num_folds`` folds × ``num_passes`` passes.

    ``infos``: a foreground info dict or a flat list (car / truck / bus
    kept); ``build_fold_apply(fold) -> apply(batch, eps)`` the fold's GLENet
    (:func:`glenet_apply`); ``draw(fold, pass, batch, shape, device)`` the
    normal draws (:func:`seeded_draws` by default) of ``(B, latent_size)``.
    One dataset serves a fold's passes: its ``RandomState(1000 + fold)``
    goes on drawing from pass to pass, as in the JAX package.  Without
    ``text_feat`` the CLIP table is zeros."""
    from ..datasets.object_uncertainty import (
        CLASS_NAMES,
        ObjectUncertaintyDataset,
        flatten_uncertainty_infos,
        kfold_val_indices,
    )

    draw = draw or seeded_draws()
    if text_feat is None:
        text_feat = {c: np.zeros((1, 512), np.float32) for c in CLASS_NAMES}
    used_infos = flatten_uncertainty_infos(infos)
    folds = kfold_val_indices(len(used_infos))
    result_json = {}
    for fold_idx in range(num_folds):
        apply_fn = build_fold_apply(fold_idx)
        ds = ObjectUncertaintyDataset(used_infos, fold_idx, text_feat, training=False, point_dims=point_dims,
                                      rng=np.random.RandomState(1000 + fold_idx))
        passes = []
        for j in range(num_passes):
            def pass_draw(bi, n, _j=j):
                return draw(fold_idx, _j, bi, (n, latent_size), device)

            passes.append(glenet_pass_records(apply_fn, ds, pass_draw, batch_size, device))
        key_l, pointnum_l, overlap_l, variance_l = single_fold_data(passes, used_infos, folds[fold_idx])
        for i in range(len(key_l)):
            result_json[key_l[i]] = {"variance": variance_l[i], "overlap": overlap_l[i], "pointnum": pointnum_l[i]}
    return compute_regression_metrics_fixed_bins(result_json)


def compute_dcf(detection_results: dict, keep_classes=("car", "truck", "bus", "pedestrian")) -> dict:
    """DCF, the mean detector confidence per class, of ``{class: [{name,
    score, ...}]}``."""
    class_scores = defaultdict(list)
    for class_name, objs in detection_results.items():
        if class_name in keep_classes:
            for det in objs:
                class_scores[det["name"]].append(det["score"])
    return {cls: float(round(float(np.mean(scores)), 4)) for cls, scores in class_scores.items()}
