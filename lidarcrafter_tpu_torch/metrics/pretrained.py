"""The evaluation backbones as bound extractors, from the pretrained folder
or from a seed.

Port of the JAX package's ``metrics/pretrained.py``.  Layout under
``pretrained_root`` (upstream's ``pretrained_models/evaluation`` tree):

  {root}/{dataset}/rangenet/{backbone,segmentation_decoder}   torch pickles
  {root}/{dataset}/{minkowskinet,spvcnn}/model.ckpt           torchsparse v1.4
  {root}/**/pointnet*.pth                                     ShapeNet PointNet

Each loader returns ``apply(x) -> (B, F)`` on ``device``, or None when its
checkpoint is absent; the random ones fill the model with
``weights.init_random_`` from ``seed``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch

from .. import resolve_device
from ..weights import init_random_
from . import DATASET_CONFIG
from .extractor.pointnet import PointNetFeatureExtractor, convert_pointnet_state_dict
from .extractor.rangenet import RangeNet, backbone_of, convert_rangenet_folder, preprocess_range_input
from .extractor.sparse_unet import backbone_from_state_dict, make_sparse_descriptor_fn

EVAL_VOXEL_SIZE = 0.05  # the voxel of upstream's FSVD / FPVD backbones


def rangenet_lidargen(model: RangeNet) -> Callable:
    """``apply(img (B, 5, H, W) [range, x, y, z, remission]) -> (B, 4096)``
    FRD features of ``model``, on its device."""
    model.eval()

    @torch.inference_mode()
    def apply(img):
        return model(preprocess_range_input(img), "lidargen")

    return apply


def pointnet_features(model: PointNetFeatureExtractor) -> Callable:
    """``apply(pts (B, N, 3)) -> (B, 1808)`` FPD features of ``model``."""
    model.eval()

    @torch.inference_mode()
    def apply(pts):
        return model(pts)

    return apply


def load_rangenet_folder(folder, device: str | torch.device = "cuda") -> RangeNet:
    """The RangeNet of a pretrained folder (``backbone`` +
    ``segmentation_decoder``), 53 or 21 by its blocks, on ``device``."""
    folder = Path(folder)
    backbone = torch.load(folder / "backbone", map_location="cpu", weights_only=False)
    decoder = torch.load(folder / "segmentation_decoder", map_location="cpu", weights_only=False)
    model = RangeNet(num_classes=17, backbone=backbone_of(backbone))
    model.load_state_dict(convert_rangenet_folder(backbone, decoder))
    return model.to(resolve_device(device)).eval()


def load_rangenet_lidargen(pretrained_root, dataset: str = "32", device: str | torch.device = "cuda"):
    """The pretrained RangeNet's FRD extractor (:func:`rangenet_lidargen`),
    or None when ``{root}/{dataset}/rangenet`` does not exist."""
    folder = Path(pretrained_root) / dataset / "rangenet"
    if not folder.exists():
        return None
    return rangenet_lidargen(load_rangenet_folder(folder, device))


def load_pointnet(pretrained_root, device: str | torch.device = "cuda"):
    """The pretrained ShapeNet PointNet's FPD extractor, or None when no
    ``pointnet*.pth`` lies under ``pretrained_root``."""
    cands = list(Path(pretrained_root).rglob("pointnet*.pth"))
    if not cands:
        return None
    sd = torch.load(cands[0], map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = PointNetFeatureExtractor()
    model.load_state_dict(convert_pointnet_state_dict(sd))
    return pointnet_features(model.to(resolve_device(device)))


def load_sparse_backbone(folder, name: str, max_points: int = 32768, device: str | torch.device = "cuda"):
    """The MinkowskiNet (``name`` 'minkowskinet') or SPVCNN ('spvcnn') of
    ``{folder}/model.ckpt``, a torchsparse state dict (or one under
    ``'state_dict'``), with the widths it holds, on ``device``."""
    path = Path(folder) / "model.ckpt"
    if not path.exists():
        raise FileNotFoundError(f"no {name} eval checkpoint: {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = backbone_from_state_dict(ckpt.get("state_dict", ckpt), name, EVAL_VOXEL_SIZE, max_points)
    return model.to(resolve_device(device))


def load_sparse_descriptor(pretrained_root, name: str, dataset: str = "nuscenes", max_points: int = 32768,
                           device: str | torch.device = "cuda"):
    """``EvaluationEngine``'s ``voxel_apply`` (``name`` 'minkowskinet') or
    ``point_voxel_apply`` ('spvcnn') from ``{root}/{dataset}/{name}``: the
    backbone's 16 depth shells, or None when that folder does not exist."""
    folder = Path(pretrained_root) / dataset / name
    if not folder.exists():
        return None
    depth_range = tuple(DATASET_CONFIG[dataset]["depth_range"])
    return make_sparse_descriptor_fn(load_sparse_backbone(folder, name, max_points, device), depth_range=depth_range)


def random_rangenet_lidargen(seed: int = 0, backbone: int = 21, device: str | torch.device = "cuda"):
    """A RangeNet's FRD extractor with weights drawn from ``seed``."""
    model = init_random_(RangeNet(num_classes=17, backbone=backbone), seed)
    return rangenet_lidargen(model.to(resolve_device(device)))


def random_pointnet(seed: int = 0, device: str | torch.device = "cuda"):
    """A PointNet's FPD extractor with weights drawn from ``seed``."""
    return pointnet_features(init_random_(PointNetFeatureExtractor(), seed).to(resolve_device(device)))
