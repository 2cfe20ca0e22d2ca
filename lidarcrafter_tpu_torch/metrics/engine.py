"""The evaluation engine: feature extraction with an on-disk cache, then the
scene-level suite.

Port of the JAX package's ``metrics/engine.py``: RangeNet range-image
features, PointNet cloud features and BEV histograms of the real and the
generated set, computed cloud by cloud on ``device`` and cached as a pickle
of numpy arrays (the JAX engine's format), then FRD / FPD (Fréchet and
squared MMD), BEV JSD / MMD and optional CD / EMD, with the same result
keys and JSON.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops.bev import point_cloud_to_histogram
from ..ops.projection import points_to_range_image
from ..utils.lidar import LiDARUtility
from .bev import compute_jsd_2d, compute_mmd_2d
from .distribution import compute_frechet_distance, compute_squared_mmd
from .eval_suite import compute_cd, compute_emd, sparse_input

_FEATURES = ("rangenet", "pointnet", "bev_hist", "voxel", "point_voxel")
_FRECHET = (("frd", "rangenet"), ("fpd", "pointnet"), ("fsvd", "voxel"), ("fpvd", "point_voxel"))


class EvaluationEngine:
    """``rangenet_apply(img (B, 5, H, W)) -> (B, F)`` and
    ``pointnet_apply(pts (B, N, 3)) -> (B, F)`` are bound extractors
    (``metrics/pretrained.py``), ``voxel_apply`` / ``point_voxel_apply``
    take ``_sparse_input``'s (points, feats, mask); None skips a metric."""

    def __init__(
        self,
        lidar_utils: LiDARUtility | None = None,
        rangenet_apply: Callable | None = None,
        pointnet_apply: Callable | None = None,
        voxel_apply: Callable | None = None,
        point_voxel_apply: Callable | None = None,
        cache_dir: str | None = None,
        num_points_pointnet: int = 2048,
        max_points_sparse: int = 32768,
        depth_range: tuple = (1.0, 45.0),
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.lidar_utils = lidar_utils or LiDARUtility.create((32, 1024), "log_depth", 1.45, 80.0)
        self.rangenet_apply = rangenet_apply
        self.pointnet_apply = pointnet_apply
        self.voxel_apply = voxel_apply
        self.point_voxel_apply = point_voxel_apply
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.num_points_pointnet = num_points_pointnet
        self.max_points_sparse = max_points_sparse
        self.depth_range = depth_range

    # ------------------------------------------------------------- features

    def _range_input(self, points: torch.Tensor) -> torch.Tensor:
        """(N, ≥3) cloud on the device → (1, 5, H, W) [range, x, y, z,
        remission] RangeNet input, zero where no point in the depth range
        fell."""
        H, W = self.lidar_utils.resolution
        if points.shape[1] < 4:
            points = torch.cat([points, points.new_zeros(len(points), 1)], 1)
        img = points_to_range_image(points[:, :4], H=H, W=W, min_depth=self.lidar_utils.min_depth,
                                    max_depth=self.lidar_utils.max_depth)
        valid = img[..., 5:6]
        x = torch.cat([img[..., 4:5] * valid, img[..., :3] * valid, img[..., 3:4] * valid], dim=-1)
        return x.permute(2, 0, 1)[None]

    def _subsample(self, points: np.ndarray) -> np.ndarray:
        n = self.num_points_pointnet
        idx = np.random.RandomState(0).choice(len(points), n, replace=len(points) < n)
        return points[idx, :3]

    def _sparse_input(self, points: np.ndarray):
        """Cloud → padded (points, feats [x, y, z, -1], mask) on the device
        for the sparse backbones: points in the depth range, at most
        ``max_points_sparse``."""
        arrays = sparse_input(points, self.depth_range, self.max_points_sparse)
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def extract_features(self, clouds: Iterable[np.ndarray], tag: str) -> dict:
        """Per-set features (numpy, one row a cloud; None where no
        extractor), read from and written to ``features_{tag}.pkl`` in the
        cache directory."""
        cache = self.cache_dir / f"features_{tag}.pkl" if self.cache_dir is not None else None
        if cache is not None and cache.exists():
            with open(cache, "rb") as f:
                return pickle.load(f)
        feats = {k: [] for k in _FEATURES}
        with torch.inference_mode():
            for pts in clouds:
                pts = np.asarray(pts, np.float32)
                cloud = torch.as_tensor(pts, device=self.device)
                feats["bev_hist"].append(point_cloud_to_histogram(cloud[:, :3]))
                if self.rangenet_apply is not None:
                    feats["rangenet"].append(self.rangenet_apply(self._range_input(cloud))[0])
                if self.pointnet_apply is not None:
                    sub = torch.as_tensor(self._subsample(pts), device=self.device)
                    feats["pointnet"].append(self.pointnet_apply(sub[None])[0])
                if self.voxel_apply is not None or self.point_voxel_apply is not None:
                    sp = self._sparse_input(pts)
                    for key, apply in (("voxel", self.voxel_apply), ("point_voxel", self.point_voxel_apply)):
                        if apply is not None:
                            feats[key].append(apply(*sp))
        out = {k: (torch.stack(v).cpu().numpy() if v else None) for k, v in feats.items()}
        if cache is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(out, f)
        return out

    # -------------------------------------------------------------- evaluate

    def evaluate(
        self,
        real_clouds: Sequence[np.ndarray],
        gen_clouds: Sequence[np.ndarray],
        metrics: Sequence[str] = ("frd", "fpd", "jsd", "mmd"),
        output_json: str | None = None,
    ) -> dict:
        """The requested metrics of the two sets: ``frd`` / ``fpd`` / ``fsvd``
        / ``fpvd`` (each with its ``*_mmd``), ``jsd``, ``mmd``, ``cd``,
        ``emd``; written to ``output_json`` as well when given."""
        real = self.extract_features(real_clouds, "real")
        gen = self.extract_features(gen_clouds, "gen")
        results: dict = {}
        for name, key in _FRECHET:
            if name in metrics and real[key] is not None:
                results[name] = compute_frechet_distance(real[key], gen[key], device=self.device)
                results[f"{name}_mmd"] = compute_squared_mmd(real[key], gen[key], device=self.device)
        hists = [torch.as_tensor(f["bev_hist"], device=self.device) for f in (real, gen)]
        if "jsd" in metrics:
            results["jsd"] = compute_jsd_2d(*hists)
        if "mmd" in metrics:
            results["mmd"] = compute_mmd_2d(*hists)
        if "cd" in metrics:
            results["cd"] = compute_cd(real_clouds, gen_clouds, self.device)
        if "emd" in metrics:
            results["emd"] = compute_emd(real_clouds, gen_clouds, self.device)
        if output_json:
            with open(output_json, "w") as f:
                json.dump({k: float(v) for k, v in results.items()}, f, indent=2)
        return results
