"""One-command evaluation: the port's counterpart of the JAX
package's ``tools/evaluate_our.py``, with its flags and ``--device`` (CUDA
unless asked for the CPU).

One invocation computes the scene metrics (frd / fpd / jsd / mmd, cd /
emd, frid / fsvd / fpvd) and the object metrics (dcf / cgf / rgf, and
``obj``: the car crops' PointMLP-feature Fréchet distance and squared MMD
and their BEV-histogram JSD / MMD against the real arm's), caches the
features, runs the ``ori`` control arm, and writes the nested JSON
``{dataset}_{method}_results.json``.

Files (as upstream's ``generated_results``):
  {sample_dir}/{method}/*.txt|*.npy|*.bin                          generated clouds
  {sample_dir}/{method}/inference_results/                         feature caches
  {sample_dir}/{method}/inference_results/foreground_samples_info.pkl
      (``extract_foreground``'s; the ``ori`` arm's comes from real clouds)

Object networks: ``--pointmlp-ckpt`` a ``train_pointmlp`` checkpoint;
GLENet from ``--glenet-fold-dir`` (``train_glenet``'s ``fold_{i}/``) or one
upstream ``--glenet-ckpt`` for every fold; ``--random-extractors`` seeded
weights for both.  RGF draws its normal samples from a generator on the
device seeded per (fold, pass) (``metrics/fg_object.py::seeded_draws``).

Usage::

  python -m lidarcrafter_tpu_torch.evaluate_our --method our --sample-dir generated_results \\
      --real-dir data/real_clouds -m frd fpd jsd mmd dcf cgf rgf obj \\
      --pretrained-root pretrained_models/evaluation -o results.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pickle
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import resolve_device

CLASS_NAMES = ("car", "truck", "bus", "pedestrian")
SCENE_METRICS = {"frd", "fpd", "jsd", "mmd", "cd", "emd", "frid", "fsvd", "fpvd"}
OBJECT_METRICS = {"dcf", "cgf", "rgf", "obj"}


def _load_dir(d, limit=None):
    from .utils.progress import Bar
    from .utils.sample_io import list_sample_files, load_point_file

    out = []
    for f in Bar.wrap(list_sample_files(d, limit), desc=f"load {Path(d).name}"):
        arr = load_point_file(f)
        if arr.shape[1] < 4:
            arr = np.concatenate([arr, np.zeros((len(arr), 1))], 1)
        out.append(arr[:, :4].astype(np.float32))
    if not out:
        raise SystemExit(f"no .txt/.npy/.bin/.pth point files found in {d}")
    return out


def _load_fg_info(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _fg_crops(info, num_points=1024, seed=0):
    """Foreground info → (clouds (M, N, 4), labels, point counts, keys): each
    crop read from its ``.bin`` and resampled to ``num_points``."""
    from .datasets import transforms as T

    r = np.random.RandomState(seed)
    clouds, labels, npts, keys = [], [], [], []
    for cls, recs in info.items():
        if cls not in CLASS_NAMES:
            continue
        for i, rec in enumerate(recs):
            pts = np.fromfile(rec["path"], np.float32).reshape(-1, 4)
            clouds.append(T.sample_points(pts, num_points, rng=r))
            labels.append(CLASS_NAMES.index(cls))
            npts.append(rec["num_points_in_gt"])
            keys.append(f"{cls}_{i}")
    if not clouds:
        raise SystemExit("no foreground crops found in the info pkl")
    return np.stack(clouds), np.asarray(labels), np.asarray(npts), keys


def _build_pointmlp(args, device):
    """The PointMLP (CGF and the obj features), or None."""
    from .metrics.extractor.pointmlp import load_pointmlp, point_mlp
    from .weights import init_random_

    if args.pointmlp_ckpt:
        return load_pointmlp(args.pointmlp_ckpt, device)
    if args.random_extractors:
        return init_random_(point_mlp(num_classes=4, points=args.num_obj_points), 0).to(device).eval()
    return None


def _rgf_metric(args, info, device):
    """RGF over ``--rgf-folds`` folds × ``--mc-passes`` passes, or None
    without GLENet weights."""
    from .datasets.object_uncertainty import CLASS_NAMES as RGF_CLASSES
    from .metrics.fg_object import compute_rgf_folds, glenet_apply, seeded_draws
    from .metrics.models.glenet import EXP20_KWARGS, GLENet, load_glenet_fold, load_glenet_from_torch
    from .weights import init_random_

    table = {c: np.zeros((1, 512), np.float32) for c in RGF_CLASSES}
    if args.clip_cache and Path(args.clip_cache).exists():
        with open(args.clip_cache, "rb") as f:
            loaded = pickle.load(f)
        for c in RGF_CLASSES:
            if c in loaded:
                table[c] = np.asarray(loaded[c], np.float32).reshape(1, -1)

    shared = None
    if not args.glenet_fold_dir:
        if args.glenet_ckpt:
            shared = load_glenet_from_torch(args.glenet_ckpt, device, **EXP20_KWARGS)
        elif args.random_extractors:
            shared = init_random_(GLENet(**EXP20_KWARGS), 0).to(device).eval()
        else:
            return None

    def build_fold_apply(fold_idx):
        if args.glenet_fold_dir:
            return glenet_apply(load_glenet_fold(Path(args.glenet_fold_dir) / f"fold_{fold_idx}", device))
        return glenet_apply(shared)

    latent = shared.latent_size if shared is not None else EXP20_KWARGS["latent_size"]
    return compute_rgf_folds(info, build_fold_apply, seeded_draws(7), num_passes=args.mc_passes,
                             num_folds=args.rgf_folds, batch_size=args.batch_size, text_feat=table,
                             latent_size=latent, device=device)


def _obj_metrics(model, crops, labels, real_crops, real_labels, device) -> dict:
    """The car crops of both arms: PointMLP-feature Fréchet distance and
    squared MMD, BEV-histogram JSD and MMD; None (the section left out)
    where an arm holds fewer than 2 car crops, where the JAX tool fails."""
    from .metrics.bev import compute_jsd_2d, compute_mmd_2d
    from .metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from .ops.bev import point_cloud_to_histogram

    cls_idx = CLASS_NAMES.index("car")

    @torch.inference_mode()
    def feats_hists(cr, lb):
        sel = torch.as_tensor(cr[lb == cls_idx][..., :3], device=device)
        feats = model(sel, return_features=True)
        hists = torch.stack([point_cloud_to_histogram(c, min_depth=1e-6, max_depth=1e3, field_size=2.0) for c in sel])
        return feats, hists

    if min((real_labels == cls_idx).sum(), (labels == cls_idx).sum()) < 2:
        print("obj: fewer than 2 car crops in an arm; skipped")
        return None
    rf, rh = feats_hists(real_crops, real_labels)
    gf, gh = feats_hists(crops, labels)
    return {"frechet_distance": compute_frechet_distance(rf, gf, device=device),
            "squared_mmd": compute_squared_mmd(rf, gf, device=device),
            "jsd": compute_jsd_2d(rh, gh), "mmd": compute_mmd_2d(rh, gh)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--method", default="ori")
    p.add_argument("--sample-dir", default="generated_results")
    p.add_argument("--real-dir", default=None, help="directory of real clouds (needed unless cached)")
    p.add_argument("-m", "--metrics", nargs="+", default=["frd", "fpd", "jsd", "mmd", "dcf", "cgf", "rgf", "obj"])
    p.add_argument("--num-sample", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--dataset", default="nuscenes")
    p.add_argument("--pretrained-root", default=None,
                   help="evaluation checkpoints root ({root}/{dataset}/rangenet/, pointnet*.pth, ...)")
    p.add_argument("--pointmlp-ckpt", default=None, help="train_pointmlp checkpoint directory")
    p.add_argument("--glenet-ckpt", default=None, help="one upstream GLENet checkpoint for every fold")
    p.add_argument("--glenet-fold-dir", default=None, help="directory of train_glenet's fold_{i}/")
    p.add_argument("--rgf-folds", type=int, default=10)
    p.add_argument("--clip-cache", default=None, help="pickle {class_name: (512,) text feature} for GLENet")
    p.add_argument("--random-extractors", action="store_true", help="seeded PointMLP / GLENet (pipeline smoke runs)")
    p.add_argument("--num-obj-points", type=int, default=1024)
    p.add_argument("--mc-passes", type=int, default=30)
    p.add_argument("--real-fg-info", default=None)
    p.add_argument("--gen-fg-info", default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .metrics import fg_object

    method = args.method
    sample_dir = Path(args.sample_dir)
    ori_cache = sample_dir / "ori" / "inference_results"
    gen_cache = sample_dir / method / "inference_results"
    gen_cache.mkdir(parents=True, exist_ok=True)
    ori_cache.mkdir(parents=True, exist_ok=True)
    results = defaultdict(dict)

    # ---------------------------------------------------------- scene metrics
    scene_metrics = SCENE_METRICS & set(args.metrics)
    if scene_metrics and method != "ori":
        results.update(_scene_metrics(args, scene_metrics, sample_dir / method, ori_cache, gen_cache, device))

    # --------------------------------------------------------- object metrics
    fg_info_path = Path(
        (args.gen_fg_info if method != "ori" else args.real_fg_info)
        or (gen_cache if method != "ori" else ori_cache) / "foreground_samples_info.pkl"
    )
    obj_metrics = OBJECT_METRICS & set(args.metrics)
    if obj_metrics:
        if not fg_info_path.exists():
            raise SystemExit(f"{fg_info_path} not found: run extract_foreground first")
        info = _load_fg_info(fg_info_path)
        if "dcf" in obj_metrics and method != "ori":
            results["object"]["dcf"] = fg_object.compute_dcf(info)
        if {"cgf", "rgf", "obj"} & obj_metrics:
            crops, labels, npts, _ = _fg_crops(info, args.num_obj_points)
            model = _build_pointmlp(args, device)
            if "cgf" in obj_metrics and model is not None:
                results["object"]["cgf"] = fg_object.compute_cgf(
                    fg_object.pointmlp_logits(model), list(crops), labels, npts, CLASS_NAMES,
                    batch_size=args.batch_size, device=device)
            if "rgf" in obj_metrics:
                rgf = _rgf_metric(args, info, device)
                if rgf is not None:
                    results["object"]["rgf"] = rgf
            if "obj" in obj_metrics and method != "ori" and model is not None:
                real_info_path = Path(args.real_fg_info or ori_cache / "foreground_samples_info.pkl")
                if real_info_path.exists():
                    rcrops, rlabels, _, _ = _fg_crops(_load_fg_info(real_info_path), args.num_obj_points)
                    obj = _obj_metrics(model, crops, labels, rcrops, rlabels, device)
                    if obj is not None:
                        results["obj"] = obj

    out_path = args.output or str(sample_dir / f"{args.dataset}_{method}_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=4)
    print(json.dumps(results, indent=2))
    return dict(results)


def _scene_metrics(args, scene_metrics, gen_dir, ori_cache, gen_cache, device) -> dict:
    """The scene sections ``img`` / ``pts`` / ``bev`` / ``scene``: features
    of the real arm cached under the ``ori`` arm, of the generated one under
    the method's."""
    from .metrics import evaluate as suite_evaluate
    from .metrics.bev import compute_jsd_2d, compute_mmd_2d
    from .metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from .metrics.engine import EvaluationEngine
    from .metrics.eval_suite import compute_cd, compute_emd
    from .metrics.pretrained import load_pointnet, load_rangenet_lidargen

    results = defaultdict(dict)
    rangenet_apply = pointnet_apply = None
    if args.pretrained_root and "frd" in scene_metrics:
        rangenet_apply = load_rangenet_lidargen(args.pretrained_root, args.dataset, device=device)
    if args.pretrained_root and "fpd" in scene_metrics:
        pointnet_apply = load_pointnet(args.pretrained_root, device=device)
    engine = EvaluationEngine(rangenet_apply=rangenet_apply, pointnet_apply=pointnet_apply,
                              cache_dir=str(ori_cache), device=device)
    real_clouds = _load_dir(args.real_dir, args.num_sample) if args.real_dir else []
    real = engine.extract_features(real_clouds, f"real_set_{args.dataset}")
    engine.cache_dir = gen_cache
    gen_clouds = _load_dir(gen_dir, args.num_sample)
    gen = engine.extract_features(gen_clouds, f"gen_set_{args.dataset}")

    for name, section, key in (("frd", "img", "rangenet"), ("fpd", "pts", "pointnet")):
        if name in scene_metrics and real[key] is not None:
            results[section]["frechet_distance"] = compute_frechet_distance(real[key], gen[key], device=device)
            results[section]["squared_mmd"] = compute_squared_mmd(real[key], gen[key], device=device)
    hists = [torch.as_tensor(f["bev_hist"], device=device) for f in (real, gen)]
    if "jsd" in scene_metrics:
        results["bev"]["jsd"] = compute_jsd_2d(*hists)
    if "mmd" in scene_metrics:
        results["bev"]["mmd"] = compute_mmd_2d(*hists)
    if "cd" in scene_metrics:
        results["scene"]["cd"] = compute_cd(real_clouds, gen_clouds, device)
    if "emd" in scene_metrics:
        results["scene"]["emd"] = compute_emd(real_clouds, gen_clouds, device)
    for name in ("frid", "fsvd", "fpvd"):
        if name in scene_metrics and args.pretrained_root:
            results["scene"].update({k: float(v) for k, v in suite_evaluate(
                real_clouds, gen_clouds, metrics=[name], pretrained_root=args.pretrained_root,
                verbose=False, device=device).items()})
    return results


if __name__ == "__main__":
    main()
