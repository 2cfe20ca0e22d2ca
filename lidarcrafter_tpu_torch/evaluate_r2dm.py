"""Score R2DM-style baseline dumps: the port's counterpart of the JAX
package's ``tools/evaluate_r2dm.py``, with its flags and ``--device`` (CUDA
unless asked for the CPU).

A directory of (5, H, W) ``.pth`` range-image tensors [depth, x, y, z,
reflectance] is masked to the LiDARGen depth window (0.5, 63) and scored
with RangeNet ``lidargen`` features (FRD), PointNet features of the
flattened ``xyz · mask / 80`` clouds (FPD, zeros kept) and BEV histograms
(JSD / MMD against a ``random.Random(0)``-shuffled subsample of the real
arm), written as the nested JSON ``{img, pts, bev, info}``.  The real arm,
``--real-dir``, holds ``.pth`` dumps or point files (projected to the
resolution on the device); its features are cached as
``real_set_{H}x{W}_{key}.pkl``, the key a hash of everything they depend
on.  Extractors: ``--pretrained-root`` (the RangeNet folder and
``pointnet*.pth``), or ``--random-extractors`` (seeded weights).

Usage::

  python -m lidarcrafter_tpu_torch.evaluate_r2dm --sample-dir DIR --real-dir DIR --random-extractors [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pickle
import random
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .utils.progress import Bar
from .utils.sample_io import MAX_DEPTH, MIN_DEPTH

DATASET_MAX_DEPTH = 80.0


def _gen_image(path, H, W):
    """One generated dump → the masked (5, H, W) image and its (H, W) mask."""
    from .utils.sample_io import _nearest_exact_chw, load_pth_image

    img = load_pth_image(path)
    if img.shape[0] < 5:
        img = np.concatenate([img, np.zeros((5 - img.shape[0], *img.shape[1:]), np.float32)])
    if img.shape[1:] != (H, W):
        img = _nearest_exact_chw(img, (H, W))
    mask = ((img[0] > MIN_DEPTH) & (img[0] < MAX_DEPTH)).astype(np.float32)
    return img[:5] * mask[None], mask


def _real_image(path, H, W, min_depth, max_depth, device="cpu"):
    """One real sample → the masked (5, H, W) image and mask: a ``.pth``
    dump as :func:`_gen_image`, a point file projected on ``device`` and
    cut to the depth window."""
    from .ops.projection import points_to_range_image
    from .utils.sample_io import load_point_file

    if Path(path).suffix == ".pth":
        return _gen_image(path, H, W)
    pts = load_point_file(path)
    if pts.shape[1] < 4:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    rimg = points_to_range_image(torch.as_tensor(pts[:, :4], device=device), H=H, W=W, min_depth=min_depth,
                                 max_depth=max_depth).cpu().numpy()  # (H, W, 6): x, y, z, remission, depth, valid
    depth, valid = rimg[..., 4], rimg[..., 5]
    mask = (valid > 0) & (depth > MIN_DEPTH) & (depth < MAX_DEPTH)
    img = np.stack([depth, rimg[..., 0], rimg[..., 1], rimg[..., 2], rimg[..., 3]])
    return (img * mask[None]).astype(np.float32), mask.astype(np.float32)


def _extract(images, rangenet_apply, pointnet_apply, batch_size, with_img, device="cpu"):
    """Features of an iterable of masked (5, H, W) images, in batches on
    ``device``: RangeNet image features, PointNet features of the flattened
    xyz / 80 (zeros kept) and a BEV histogram per image, as stacked numpy."""
    from .ops.bev import point_cloud_to_histogram

    out = {"img_feats": [], "pts_feats": [], "bev_hists": []}
    batch = []

    @torch.inference_mode()
    def flush():
        if not batch:
            return
        imgs = torch.as_tensor(np.stack(batch), device=device)  # (B, 5, H, W)
        if with_img and rangenet_apply is not None:
            out["img_feats"].append(rangenet_apply(imgs).cpu().numpy())
        clouds = imgs[:, 1:4].permute(0, 2, 3, 1).reshape(len(imgs), -1, 3)
        for cloud in clouds:
            out["bev_hists"].append(point_cloud_to_histogram(cloud).cpu().numpy())
        if pointnet_apply is not None:
            out["pts_feats"].append(pointnet_apply(clouds / DATASET_MAX_DEPTH).cpu().numpy())
        batch.clear()

    for img in images:
        batch.append(img)
        if len(batch) == batch_size:
            flush()
    flush()
    return {k: (np.concatenate(v) if k != "bev_hists" else np.stack(v)) if v else None for k, v in out.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sample-dir", required=True, help="dir of generated .pth dumps")
    p.add_argument("--real-dir", required=True, help="real arm: .pth dumps or point files")
    p.add_argument("--pretrained-root", default=None,
                   help="eval-backbone checkpoints ({root}/{dataset}/rangenet, pointnet*.pth)")
    p.add_argument("--dataset", default="32", help="rangenet weights tag")
    p.add_argument("--resolution", type=int, nargs=2, default=(32, 1024))
    p.add_argument("--min-depth", type=float, default=1.45)
    p.add_argument("--max-depth", type=float, default=80.0)
    p.add_argument("--no-reflectance", action="store_true", help="skip the img branch")
    p.add_argument("--random-extractors", action="store_true", help="seeded extractors (pipeline smoke runs)")
    p.add_argument("--cache-dir", default=None, help="real-set feature cache dir (default: the sample dir's parent)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int, default=10_000, help="cap per arm")
    p.add_argument("--num-sample", type=int, default=10_000, help="real BEV-histogram subsample for jsd / mmd")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .metrics import pretrained
    from .metrics.bev import compute_jsd_2d, compute_mmd_2d
    from .metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from .utils.sample_io import list_sample_files

    H, W = args.resolution
    with_img = not args.no_reflectance
    rangenet_apply = pointnet_apply = None
    if args.random_extractors:
        rangenet_apply = pretrained.random_rangenet_lidargen(device=device) if with_img else None
        pointnet_apply = pretrained.random_pointnet(device=device)
    elif args.pretrained_root:
        if with_img:
            rangenet_apply = pretrained.load_rangenet_lidargen(args.pretrained_root, args.dataset, device=device)
        pointnet_apply = pretrained.load_pointnet(args.pretrained_root, device=device)

    results = {"img": {}, "pts": {}, "bev": {}, "info": {"directory": args.sample_dir}}

    # the real arm, cached under a key of everything its features depend on,
    # so a run with --random-extractors never feeds a pretrained one
    cache_dir = Path(args.cache_dir or Path(args.sample_dir).parent)
    cache_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha1("|".join([
        str(Path(args.real_dir).resolve()), str(args.limit),
        "rand" if args.random_extractors else (args.pretrained_root or "none"),
        args.dataset, "img" if with_img else "noimg", f"{args.min_depth}-{args.max_depth}",
    ]).encode()).hexdigest()[:10]
    cache = cache_dir / f"real_set_{H}x{W}_{key}.pkl"
    if cache.exists():
        print(f"found cached {cache}")
        with open(cache, "rb") as f:
            real_set = pickle.load(f)
    else:
        real_files = list_sample_files(args.real_dir, args.limit)
        if not real_files:
            raise SystemExit(f"no real samples in {args.real_dir}")
        real_set = _extract(
            Bar.wrap((_real_image(f, H, W, args.min_depth, args.max_depth, device)[0] for f in real_files),
                     desc="real", total=len(real_files)),
            rangenet_apply, pointnet_apply, args.batch_size, with_img, device,
        )
        with open(cache, "wb") as f:
            pickle.dump(real_set, f)
    results["info"]["#real"] = len(real_set["bev_hists"])

    gen_files = sorted(Path(args.sample_dir).glob("*.pth"))[: args.limit]
    if not gen_files:
        raise SystemExit(f"no .pth dumps in {args.sample_dir}")
    gen_set = _extract(Bar.wrap((_gen_image(f, H, W)[0] for f in gen_files), desc="gen", total=len(gen_files)),
                       rangenet_apply, pointnet_apply, args.batch_size, with_img, device)
    results["info"]["#fake"] = len(gen_set["bev_hists"])

    for section, key in (("img", "img_feats"), ("pts", "pts_feats")):
        if section == "img" and not with_img:
            continue
        if real_set[key] is not None and gen_set[key] is not None:
            results[section]["frechet_distance"] = compute_frechet_distance(real_set[key], gen_set[key], device=device)
            results[section]["squared_mmd"] = compute_squared_mmd(real_set[key], gen_set[key], device=device)

    perm = list(range(len(real_set["bev_hists"])))
    random.Random(0).shuffle(perm)
    perm = perm[: args.num_sample]
    real_hists = torch.as_tensor(real_set["bev_hists"][perm], dtype=torch.float32, device=device)
    gen_hists = torch.as_tensor(gen_set["bev_hists"], dtype=torch.float32, device=device)
    results["bev"]["jsd"] = compute_jsd_2d(real_hists, gen_hists)
    results["bev"]["mmd"] = compute_mmd_2d(real_hists, gen_hists)

    print(json.dumps(results, indent=2))
    out = args.output or (str(Path(args.sample_dir)) + "_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=4)
    print(f"saved {out}")
    return results


if __name__ == "__main__":
    main()
