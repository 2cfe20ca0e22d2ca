"""3D detection over generated scenes: the port's entry point for
``metrics.detection_eval``, with the JAX package's
``tools/evaluate_detection.py`` flags and ``--device`` (CUDA unless asked
for the CPU).

A detector runs over generated clouds that stand for real samples; recall
at rotated-IoU thresholds and the nuScenes-protocol per-class AP / mAP are
written as ``detection_eval.json`` beside the detections
(``result_vxrcnn.pkl``).  Ground truth comes from an info pickle (the
converter's nuScenes infos or a list of ``{"token", "gt_boxes",
"gt_names"}``); a generated file matches the token that ends its stem.

The detector: ``--pcdet-ckpt`` a released pcdet Voxel R-CNN (CenterHead)
checkpoint, else the substitute ``VoxelDetector`` with ``--params`` (a
pickle of its weights: the JAX tool's parameter tree, numpy leaves) or
``--random-params`` (seeded weights).

Usage::

  python -m lidarcrafter_tpu_torch.evaluate_detection --gen-dir DIR --gt-infos infos.pkl \\
      --pcdet-ckpt voxel_rcnn.pth -o OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .metrics.detection_eval import evaluate_detections, load_gt_infos, match_token
from .metrics.models.detector import VoxelDetector, predict
from .weights import init_random_, load_flax_params

CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle", "bicycle",
               "pedestrian", "traffic_cone")
DETECTOR_CLASSES = ("car", "truck", "bus", "pedestrian")  # the substitute detector's 4-class head


def load_cloud(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix == ".txt":
        return np.loadtxt(path).astype(np.float32)
    return np.fromfile(path, np.float32).reshape(-1, 5)[:, :4]


def generated_files(gen_dir) -> list[Path]:
    d = Path(gen_dir)
    return sorted(list(d.glob("*.npy")) + list(d.glob("*.txt")) + list(d.glob("*.bin")))


def padded(cloud: np.ndarray, max_points: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``max_points`` rows of ``cloud`` as (max_points, 4) and their mask."""
    n = min(len(cloud), max_points)
    pts = np.zeros((max_points, max(cloud.shape[1], 4)), np.float32)
    pts[:n] = cloud[:n, : pts.shape[1]]
    return pts[:, :4], np.arange(max_points) < n


def substitute_detector(params, random_params: bool, device, **kwargs) -> VoxelDetector:
    """The ``VoxelDetector`` with the weights of the pickle ``params`` (the
    parameter tree the JAX tools read, as numpy arrays), or seeded weights
    (seed 0) with ``random_params``."""
    model = VoxelDetector(**kwargs)
    if params:
        with open(params, "rb") as f:
            load_flax_params(model, pickle.load(f))
    elif random_params:
        init_random_(model, 0)
    else:
        raise SystemExit("pass --pcdet-ckpt, --params or --random-params")
    return model.to(device).eval()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--gt-infos", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--pcdet-ckpt", default=None, help="released pcdet Voxel R-CNN (CenterHead) checkpoint")
    p.add_argument("--params", default=None, help="pickle of the substitute VoxelDetector's weights")
    p.add_argument("--random-params", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--max-points", type=int, default=32768)
    p.add_argument("--score-thresh", type=float, default=0.1)
    p.add_argument("--classes", nargs="+", default=list(CLASS_NAMES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    gt_infos = load_gt_infos(Path(args.gt_infos))
    pairs = [(f, t) for f in generated_files(args.gen_dir) if (t := match_token(f.stem, gt_infos)) is not None]
    if args.limit:
        pairs = pairs[: args.limit]
    if not pairs:
        raise SystemExit(f"no generated clouds in {args.gen_dir} matched tokens in {args.gt_infos}")

    if args.pcdet_ckpt:
        from .metrics.models.voxel_rcnn import load_voxel_rcnn_from_pcdet

        det = load_voxel_rcnn_from_pcdet(args.pcdet_ckpt, score_thresh=args.score_thresh, device=device)

        def run(points, mask):
            boxes, scores, names, valid = det.predict(points, mask)
            keep = valid.cpu().numpy()
            return boxes.cpu().numpy()[keep], scores.cpu().numpy()[keep], np.asarray(names, object)[keep]
    else:
        model = substitute_detector(args.params, args.random_params, device)

        def run(points, mask):
            boxes, scores, labels, valid = predict(model, points, mask, score_thresh=args.score_thresh)
            keep = valid.cpu().numpy()
            names = np.asarray([DETECTOR_CLASSES[int(lab) % len(DETECTOR_CLASSES)] for lab in labels.tolist()],
                               object)
            return boxes.cpu().numpy()[keep], scores.cpu().numpy()[keep], names[keep]

    det_annos, gt_annos = [], []
    for f, token in pairs:
        pts, mask = padded(load_cloud(f), args.max_points)
        boxes, scores, names = run(torch.as_tensor(pts, device=device), torch.as_tensor(mask, device=device))
        det_annos.append({"boxes_lidar": boxes, "score": scores, "name": names, "frame_id": token})
        gt_annos.append({"gt_boxes": gt_infos[token]["gt_boxes"], "name": gt_infos[token]["gt_names"]})

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "result_vxrcnn.pkl", "wb") as f:
        pickle.dump(det_annos, f)
    result = evaluate_detections(det_annos, gt_annos, args.classes, device=device)
    with open(out_dir / "detection_eval.json", "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
