"""Model/engine factory.

Port of the JAX package's ``training/factory.py``: every branch of
``build_diffusion_training`` — unconditional continuous time
(``nuscenes-unet-uncond``, ``kitti-360``, ``nuscenes-hdit-uncond``), the
layout-conditioned stacks (the v0 ``LayoutUnet`` of ``nuscenes-box-layout``
with ``cond_mode=None``; ``LayoutUnetV1`` with ``cond_mode='concat'`` for
v1-v6 and ``nuscenes-auto-reg`` / ``-v2``, which differ in the encoder's
``out_channels`` and architecture and in the ``autoregressive_cond``
input) and discrete time (``timestep_type='discrete'``) —,
``build_flow_training``
(``meanflow-nusc``), ``build_layout_training`` (``nuscenes-layout``: scene
graph → 4D layout), ``build_object_training`` (``nuscenes-object``: box +
class → object points) and ``layout_condition_batch``.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..diffusion import CondContinuousDiffusion, CondLayoutDiffusion, ContinuousDiffusion, DiscreteDiffusion, MeanFlow
from ..models import build_model
from ..utils.lidar import LiDARUtility


def _data_channels(cfg) -> int:
    return int(cfg.data.train_depth) + int(cfg.data.train_reflectance)


def make_lidar_utils(cfg, device: str | torch.device = "cpu") -> LiDARUtility:
    return LiDARUtility.create(
        resolution=tuple(cfg.data.resolution),
        depth_format=cfg.data.depth_format,
        min_depth=cfg.data.min_depth,
        max_depth=cfg.data.max_depth,
        fov_up=cfg.data.fov_up,
        fov_down=cfg.data.fov_down,
        device=device,
    )


def layout_condition_batch(
    cfg,
    batch_size: int,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cpu",
) -> dict:
    """Condition batch at ``cfg``'s topology: ``scaled_gt_boxes (B,L,9)``,
    ``gt_boxes_2d (B,L,4)``, ``is_valid_obj (B,L)`` ones and, when the
    encoder declares ``out_channels``, a ``concat_cond`` map, which for
    autoregressive tasks cedes its last channel to a separate
    ``(B,H,W,1) autoregressive_cond``.  Zero-filled by default; with a
    ``generator``, boxes are uniform·0.5 and maps normal·0.1."""
    B = batch_size
    H, W = cfg.data.resolution
    L = cfg.condition_model.params["layout_length"]
    cc = cfg.condition_model.params.get("out_channels", 0)
    autoreg = "autoregressive" in (cfg.data.task or "")

    def boxes(shape):
        if generator is None:
            return torch.zeros(shape, device=device)
        return torch.rand(shape, generator=generator, device=device) * 0.5

    def cond_map(shape):
        if generator is None:
            return torch.zeros(shape, device=device)
        return torch.randn(shape, generator=generator, device=device) * 0.1

    batch = {
        "scaled_gt_boxes": boxes((B, L, 9)),
        "gt_boxes_2d": boxes((B, L, 4)),
        "is_valid_obj": torch.ones((B, L), device=device),
    }
    if cc and autoreg:
        batch["concat_cond"] = cond_map((B, H, W, cc - 1))
        batch["autoregressive_cond"] = cond_map((B, H, W, 1))
    elif cc:
        batch["concat_cond"] = cond_map((B, H, W, cc))
    return batch


def _build_denoiser(cfg, in_channels: int, device: torch.device, **extra):
    """``cfg.model`` in ``eval()`` mode on ``device``; the coordinate
    encoding follows the projection as in the JAX package.

    Training keeps ``eval()`` too: the layout configs set ``dropout: 0.1``,
    but the JAX trainer never passes ``deterministic=False`` (its train step
    applies the models without it), so the JAX package trains with dropout
    off, and so does the port."""
    model = build_model(
        cfg.model.architecture,
        in_channels=in_channels,
        resolution=tuple(cfg.data.resolution),
        use_ray_angle_coords="spherical" in cfg.data.projection,
        fov_up=cfg.data.fov_up,
        fov_down=cfg.data.fov_down,
        **extra,
        **cfg.model.params,
    )
    return model.to(device).eval()


def build_diffusion_training(cfg, device: str | torch.device = "cuda"):
    """The image-diffusion branches, built on ``device``.

    Unconditional configs give ``(model, ContinuousDiffusion, utils)``;
    conditioned ones give ``({'model': denoiser, 'cond': encoder},
    CondContinuousDiffusion, utils)``; ``timestep_type='discrete'`` gives
    ``(model, DiscreteDiffusion, utils)`` (the config must set
    ``num_training_steps``, which every registry config leaves None, as the
    JAX factory needs it too).  With
    ``cond_mode='concat'`` the denoiser's input widens by the encoder's
    ``out_channels``; with ``cond_mode=None`` (v0) it does not.  Models are
    in ``eval()`` mode (dropout off, as the JAX trainer runs them) with
    float32 parameters that require grad: the same build serves and trains.
    """
    device = resolve_device(device)
    data_channels = _data_channels(cfg)
    sampling_shape = (*cfg.data.resolution, data_channels)
    conditioned = getattr(cfg, "condition_model", None) is not None
    cond_mode = cfg.diffusion.cond_mode
    if cond_mode not in ("concat", None):
        raise ValueError(f"cond_mode {cond_mode!r}")
    in_channels, extra = data_channels, {}
    if conditioned:
        cp = cfg.condition_model.params
        if cond_mode == "concat":
            in_channels += cp["out_channels"]
        if cfg.model.architecture in ("layout_unet", "layout_unet_v1"):
            extra["layout_channels"] = cp["hidden_dim"]
    model = _build_denoiser(cfg, in_channels, device, **extra)
    lidar_utils = make_lidar_utils(cfg, device)

    if cfg.diffusion.timestep_type == "discrete":
        if cfg.diffusion.num_training_steps is None:
            raise ValueError("timestep_type='discrete' needs cfg.diffusion.num_training_steps")
        engine = DiscreteDiffusion(
            model=model, sampling_shape=sampling_shape,
            num_training_steps=cfg.diffusion.num_training_steps,
            prediction_type=cfg.diffusion.prediction_type, loss_type=cfg.diffusion.loss_type,
            noise_schedule=cfg.diffusion.noise_schedule,
        )
        return model, engine, lidar_utils
    engine_kw = _engine_kw(cfg, sampling_shape)
    if not conditioned:
        return model, ContinuousDiffusion(model=model, **engine_kw), lidar_utils
    cond_model = build_model(cfg.condition_model.architecture, **cfg.condition_model.params)
    cond_model = cond_model.to(device).eval()
    engine = CondContinuousDiffusion(
        model=model, cond_model=cond_model, cond_mode=cond_mode,
        w_loss_weight=cfg.diffusion.w_loss_weight, **engine_kw,
    )
    return {"model": model, "cond": cond_model}, engine, lidar_utils


def build_flow_training(cfg, device: str | torch.device = "cuda"):
    """The MeanFlow branch: ``(MFEfficientUNet, MeanFlow, utils)`` on
    ``device``; the model is in ``eval()`` mode."""
    device = resolve_device(device)
    if getattr(cfg, "flow", None) is None:
        raise ValueError("not a flow config (cfg.flow is None)")
    model = _build_denoiser(cfg, _data_channels(cfg), device)
    dist, mu, sigma = cfg.flow.time_dist
    engine = MeanFlow(model=model, sampling_shape=(*cfg.data.resolution, _data_channels(cfg)),
                      flow_ratio=cfg.flow.flow_ratio, time_dist=dist, time_mu=float(mu), time_sigma=float(sigma))
    return model, engine, make_lidar_utils(cfg, device)


def _engine_kw(cfg, sampling_shape) -> dict:
    return dict(
        sampling_shape=sampling_shape,
        prediction_type=cfg.diffusion.prediction_type,
        loss_type=cfg.diffusion.loss_type,
        noise_schedule=cfg.diffusion.noise_schedule,
        clip_sample=cfg.diffusion.clip_sample,
    )


def build_layout_training(cfg, device: str | torch.device = "cuda", num_objs: int = 9, num_preds: int = 16):
    """The 1D layout branch on ``device``: ``({'model': UNet1DModel, 'cond':
    SceneGraph}, CondLayoutDiffusion, utils)``, models in ``eval()`` mode.
    The scene graph's vocabulary sizes come from the dataset in the
    reference and are passed here, as in the JAX package."""
    device = resolve_device(device)
    model = build_model(cfg.model.architecture, **cfg.model.params).to(device).eval()
    cond_model = build_model(
        cfg.condition_model.architecture, num_objs=num_objs, num_preds=num_preds, **cfg.condition_model.params
    ).to(device).eval()
    engine = CondLayoutDiffusion(
        model=model, cond_model=cond_model,
        **_engine_kw(cfg, (cfg.model.params.get("in_channels", 20),)),
    )
    return {"model": model, "cond": cond_model}, engine, make_lidar_utils(cfg, device)


def build_object_training(cfg, device: str | torch.device = "cuda"):
    """The per-object point branch on ``device``: ``({'model': PointUNet,
    'cond': ObjectGenEncoder}, CondContinuousDiffusion, utils)`` over
    (num_samples, point_dim) clouds, models in ``eval()`` mode."""
    device = resolve_device(device)
    model = build_model(cfg.model.architecture, **cfg.model.params).to(device).eval()
    cond_model = build_model(cfg.condition_model.architecture, **cfg.condition_model.params).to(device).eval()
    engine = CondContinuousDiffusion(
        model=model, cond_model=cond_model,
        **_engine_kw(cfg, (cfg.data.num_samples, cfg.model.params["point_dim"])),
    )
    return {"model": model, "cond": cond_model}, engine, make_lidar_utils(cfg, device)
