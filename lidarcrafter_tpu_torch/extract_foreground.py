"""Foreground objects of generated clouds (the DCF pipeline's input): the
port's counterpart of the JAX package's ``tools/extract_foreground.py``,
with its flags and ``--device`` (CUDA unless asked for the CPU).

A detector runs over each generated cloud, and the points inside each
detection (at least ``--min-points``), centred at the box, are written as
``foreground_samples/{frame}_{class}_{i}.bin`` with
``foreground_samples_info.pkl`` (by class) and ``result.pkl`` (the
detections).  The detector: ``--pcdet-ckpt`` (a released pcdet Voxel R-CNN;
its detections outside car / truck / bus / pedestrian are dropped), else the
substitute ``VoxelDetector`` with ``--params`` or ``--random-params``; or
no detector, with the ground-truth boxes of ``--gt-infos`` (classes
``--keep-classes``, by default car, truck and bus).

Usage::

  python -m lidarcrafter_tpu_torch.extract_foreground --gen-dir DIR -o OUT --random-params [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .evaluate_detection import generated_files, load_cloud, substitute_detector
from .metrics.detection_eval import load_gt_infos, match_token
from .metrics.models.detector import predict
from .ops.points import points_in_boxes

CLASS_NAMES = ("car", "truck", "bus", "pedestrian")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gen-dir", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--params", default=None, help="pickle of the substitute VoxelDetector's weights")
    p.add_argument("--random-params", action="store_true")
    p.add_argument("--pcdet-ckpt", default=None, help="released pcdet Voxel R-CNN (CenterHead) checkpoint")
    p.add_argument("--gt-infos", default=None, help="info pkl: extract with the ground-truth boxes instead")
    p.add_argument("--keep-classes", nargs="+", default=None, help="classes of --gt-infos (car truck bus)")
    p.add_argument("--frame-rotate-deg", type=float, default=0.0, help="turn the clouds about z first")
    p.add_argument("--z-offset", type=float, default=0.0, help="then move them along z")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--max-points", type=int, default=32768)
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--min-points", type=int, default=50)
    p.add_argument("--voxel-size", type=float, default=0.3)
    p.add_argument("--point-range", type=float, nargs=6, default=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    files = generated_files(args.gen_dir)
    if args.limit:
        files = files[: args.limit]
    if not files:
        raise SystemExit(f"no generated clouds found in {args.gen_dir}")
    P = args.max_points

    gt_infos = detect = None
    if args.gt_infos:
        gt_infos = load_gt_infos(args.gt_infos)
        keep_classes = args.keep_classes or ["car", "truck", "bus"]
    elif args.pcdet_ckpt:
        from .metrics.models.voxel_rcnn import load_voxel_rcnn_from_pcdet

        det = load_voxel_rcnn_from_pcdet(args.pcdet_ckpt, point_range=tuple(args.point_range),
                                         score_thresh=args.score_thresh, device=device)

        def detect(pts, msk):
            boxes, scores, names, valid = det.predict(pts, msk)
            labels = np.array([CLASS_NAMES.index(n) if n in CLASS_NAMES else -1 for n in names], np.int64)
            return boxes, scores, np.maximum(labels, 0), valid.cpu().numpy() & (labels >= 0)
    else:
        model = substitute_detector(args.params, args.random_params, device, voxel_size=args.voxel_size,
                                    point_range=tuple(args.point_range))

        def detect(pts, msk):
            boxes, scores, labels, valid = predict(model, pts, msk, score_thresh=args.score_thresh)
            return boxes, scores, labels.cpu().numpy(), valid.cpu().numpy()

    out = Path(args.output_dir)
    (out / "foreground_samples").mkdir(parents=True, exist_ok=True)
    det_annos, info = [], defaultdict(list)
    for frame_id, f in enumerate(files):
        cloud = load_cloud(f)[:, :4]
        if args.frame_rotate_deg:
            a = np.deg2rad(args.frame_rotate_deg)
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
            cloud = cloud.copy()
            cloud[:, :2] = cloud[:, :2] @ rot.T
        if args.z_offset:
            cloud = cloud.copy()
            cloud[:, 2] += args.z_offset
        n = min(len(cloud), P)
        pts = np.zeros((P, 4), np.float32)
        pts[:n] = cloud[:n]
        mask = np.arange(P) < n
        if gt_infos is not None:
            token = match_token(f.stem, gt_infos)
            if token is None:
                print(f"[{frame_id + 1}/{len(files)}] {f.stem}: no token match")
                continue
            gi = gt_infos[token]
            sel = np.asarray([name in keep_classes for name in gi["gt_names"]], bool)
            boxes = gi["gt_boxes"][sel].astype(np.float32)
            names = np.asarray(gi["gt_names"])[sel]
            scores = np.ones((len(boxes),), np.float32)
        else:
            boxes, scores, labels, keep = detect(torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device))
            boxes, scores, labels = boxes.cpu().numpy()[keep], scores.cpu().numpy()[keep], labels[keep]
            names = np.array([CLASS_NAMES[i] for i in labels])
        det_annos.append({"frame_id": str(frame_id), "name": names, "boxes_lidar": boxes, "score": scores})
        if len(boxes):
            inb = points_in_boxes(torch.as_tensor(pts[:, :3], device=device),
                                  torch.as_tensor(boxes.astype(np.float32), device=device)).cpu().numpy()
            for sid in range(len(boxes)):
                sel = pts[inb[sid] & mask]
                if len(sel) < args.min_points:
                    continue
                crop = sel.copy()
                crop[:, :3] -= boxes[sid, None, :3]
                path = out / "foreground_samples" / f"{frame_id}_{names[sid]}_{sid}.bin"
                crop.astype(np.float32).tofile(path)
                info[names[sid]].append({"name": names[sid], "path": str(path), "num_points_in_gt": len(sel),
                                         "box3d_lidar": boxes[sid].tolist(), "score": float(scores[sid])})
        print(f"[{frame_id + 1}/{len(files)}] dets={len(boxes)}")

    with open(out / "result.pkl", "wb") as f:
        pickle.dump(det_annos, f)
    with open(out / "foreground_samples_info.pkl", "wb") as f:
        pickle.dump(dict(info), f)
    counts = {k: len(v) for k, v in info.items()}
    print(f"foreground samples: {counts} → {out / 'foreground_samples_info.pkl'}")
    return dict(info)


if __name__ == "__main__":
    main()
