"""The metric suite over lists of clouds: the port of the JAX package's
``metrics/eval_suite.py``.

``evaluate(reference, samples, metrics, data)`` takes the same metric names:
``cd``, ``emd``, ``jsd`` and ``mmd`` run on ``device`` from the raw point
lists; ``frid``, ``fsvd`` and ``fpvd`` (Fréchet distances of perceptual
descriptors) take precomputed features through ``features``, or run the
pretrained backbones of ``pretrained_root``: RangeNet for ``frid``,
MinkowskiNet for ``fsvd`` and SPVCNN for ``fpvd``
(``{root}/{dataset}/{rangenet,minkowskinet,spvcnn}``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..ops.chamfer import chamfer_metric
from ..ops.emd import emd_metric
from ..ops.projection import points_to_range_image
from . import DATASET_CONFIG, OUTPUT_TEMPLATE, TYPE2DATASET
from .bev import bev_occupancy_grid, jensen_shannon_distance
from .distribution import compute_frechet_distance
from .extractor.rangenet import rangenet_frid_descriptor, preprocess_range_input
from .extractor.sparse_unet import make_sparse_descriptor_fn
from .pretrained import load_rangenet_folder, load_sparse_backbone

SPARSE_BACKBONES = {"fsvd": "minkowskinet", "fpvd": "spvcnn"}


def _clouds(clouds, device, dims=None) -> list[torch.Tensor]:
    return [torch.as_tensor(np.asarray(p, np.float32)[:, :dims], device=device) for p in clouds]


def _mean(vals: list[torch.Tensor]) -> float:
    return float(torch.stack(vals).double().mean())


def compute_cd(reference, samples, device: str | torch.device = "cuda") -> float:
    """Mean chamfer distance over aligned pairs of clouds."""
    pairs = zip(_clouds(reference, device), _clouds(samples, device))
    return _mean([chamfer_metric(x[None], y[None]) for x, y in pairs])


def compute_emd(reference, samples, device: str | torch.device = "cuda") -> float:
    """Mean auction EMD over aligned pairs of clouds of equal size."""
    pairs = zip(_clouds(reference, device), _clouds(samples, device))
    return _mean([emd_metric(x[None], y[None]) for x, y in pairs])


def compute_jsd(reference, samples, data: str = "32", device: str | torch.device = "cuda") -> float:
    """JSD between the summed BEV occupancy grids of the two sets."""
    ref = sum(bev_occupancy_grid(p, data_type=data) for p in _clouds(reference, device, 3))
    gen = sum(bev_occupancy_grid(p, data_type=data) for p in _clouds(samples, device, 3))
    return float(jensen_shannon_distance(ref.reshape(-1), gen.reshape(-1)))


def compute_mmd(reference, samples, data: str = "32", device: str | torch.device = "cuda") -> float:
    """Minimum matching distance: for each reference cloud the least BEV
    (xy) chamfer to any sample, averaged; O(|ref|·|gen|) chamfers."""
    gen = _clouds(samples, device, 2)
    vals = [torch.stack([chamfer_metric(r[None], s[None]) for s in gen]).min()
            for r in _clouds(reference, device, 2)]
    return _mean(vals)


def compute_fd(reference_feats, sample_feats, device: str | torch.device = "cuda") -> float:
    return compute_frechet_distance(reference_feats, sample_feats, device=device)


def _range_descriptors(clouds, data, root, agg_type="depth", device: str | torch.device = "cuda") -> torch.Tensor:
    """(len(clouds), 512) FRID descriptors on ``device`` from the pretrained
    RangeNet folder ``{root}/{dataset}/rangenet``: each cloud projected at
    the dataset's size and field of view, the decoder map (not the class
    head) averaged over 16 bands."""
    dataset = TYPE2DATASET[data]
    model = load_rangenet_folder(Path(root) / dataset / "rangenet", device)
    (H, W), (fov_up, fov_down) = DATASET_CONFIG[dataset]["size"], DATASET_CONFIG[dataset]["fov"]
    out = []
    with torch.inference_mode():
        for pts in clouds:
            pts = np.asarray(pts, np.float32)
            if pts.shape[1] < 4:
                pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
            img = points_to_range_image(torch.as_tensor(pts[:, :4], device=device), H=H, W=W,
                                        fov_up=float(fov_up), fov_down=float(fov_down))
            x = torch.cat([img[..., 4:5], img[..., :3], img[..., 3:4]], dim=-1).permute(2, 0, 1)[None]
            out.append(rangenet_frid_descriptor(model(preprocess_range_input(x), "decoder"), agg_type)[0])
    return torch.stack(out)


def sparse_input(cloud, depth_range: tuple, max_points: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A cloud as the sparse backbones take it: its points inside
    ``depth_range`` (in the order given, at most ``max_points``), padded to
    (max_points, 3), their features [x, y, z, -1] (no remission) and the
    mask of the real rows."""
    pts = np.asarray(cloud, np.float32)[:, :3]
    depth = np.linalg.norm(pts, 2, axis=1)
    pts = pts[(depth > depth_range[0]) & (depth < depth_range[1])][:max_points]
    pad = np.zeros((max_points, 3), np.float32)
    pad[: len(pts)] = pts
    feats = np.concatenate([pad, -np.ones((max_points, 1), np.float32)], 1)
    return pad, feats, np.arange(max_points) < len(pts)


def _sparse_descriptors(clouds, model_name: str, data: str, root, max_points: int,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """(len(clouds), 16·C) depth-shell descriptors on ``device`` from the
    pretrained sparse backbone ``{root}/{dataset}/{model_name}/model.ckpt``."""
    dataset = TYPE2DATASET[data]
    depth_range = tuple(DATASET_CONFIG[dataset]["depth_range"])
    model = load_sparse_backbone(Path(root) / dataset / model_name, model_name, max_points, device)
    describe = make_sparse_descriptor_fn(model, agg_type="depth", depth_range=depth_range)
    out = []
    for pts in clouds:
        out.append(describe(*(torch.as_tensor(a, device=device) for a in sparse_input(pts, depth_range, max_points))))
    return torch.stack(out)


def evaluate(
    reference,
    samples,
    metrics,
    data: str = "32",
    features: dict | None = None,
    verbose: bool = True,
    pretrained_root: str | None = None,
    max_points: int = 32768,
    device: str | torch.device = "cuda",
) -> dict:
    """Each metric of ``metrics`` between two lists of (N, ≥3) clouds, on
    ``device``.  ``features`` may carry precomputed descriptors ``{'range':
    (ref, gen), 'voxel': ..., 'point_voxel': ...}`` for frid / fsvd / fpvd;
    without them frid runs the RangeNet of ``pretrained_root`` and fsvd /
    fpvd its MinkowskiNet / SPVCNN on at most ``max_points`` points a
    cloud."""
    device = resolve_device(device)
    results = {}
    features = features or {}
    modality = {"frid": "range", "fsvd": "voxel", "fpvd": "point_voxel"}
    for name in metrics:
        if name in modality:
            feats = features.get(modality[name])
            if feats is None and pretrained_root:
                if name in SPARSE_BACKBONES:
                    feats = tuple(_sparse_descriptors(c, SPARSE_BACKBONES[name], data, pretrained_root, max_points,
                                                      device) for c in (reference, samples))
                else:
                    feats = tuple(_range_descriptors(c, data, pretrained_root, device=device)
                                  for c in (reference, samples))
            if feats is None:
                raise ValueError(
                    f"{name} needs precomputed '{modality[name]}' features "
                    "or a --pretrained-root with the eval checkpoints"
                )
            results[name] = compute_fd(*feats, device=device)
        elif name == "cd":
            results[name] = compute_cd(reference, samples, device)
        elif name == "emd":
            results[name] = compute_emd(reference, samples, device)
        elif name == "jsd":
            results[name] = compute_jsd(reference, samples, data, device)
        elif name == "mmd":
            results[name] = compute_mmd(reference, samples, data, device)
        else:
            raise ValueError(f"unknown metric: {name}")
        if verbose:
            print(OUTPUT_TEMPLATE.format(name.upper().ljust(4), results[name]))
    return results
