"""Named config registry: every config of the JAX package's registry, under
the same keys."""

import json

from . import experiments as E
from .common import ExperimentConfig  # noqa: F401

__all__ = {
    "kitti-360": E.kitti_360,
    "nuscenes-unet-uncond": E.nusc_unet_uncond,
    "nuscenes-hdit-uncond": E.nusc_hdit_uncond,
    "nuscenes-auto-reg": E.nusc_auto_reg,
    "nuscenes-auto-reg-v2": E.nusc_auto_reg_v2,
    "nuscenes-box-layout": E.nusc_box_layout,
    "nuscenes-box-layout-v1": E.nusc_box_layout_v1,
    "nuscenes-box-layout-v2": E.nusc_box_layout_v2,
    "nuscenes-box-layout-v3": E.nusc_box_layout_v3,
    "nuscenes-box-layout-v4": E.nusc_box_layout_v4,
    "nuscenes-box-layout-v5": E.nusc_box_layout_v5,
    "nuscenes-box-layout-v6": E.nusc_box_layout_v6,
    "meanflow-nusc": E.meanflow_nusc,
    "nuscenes-layout": E.nusc_layout,
    "nuscenes-object": E.nusc_object,
}


def get_config(name: str):
    return __all__[name]()


def apply_reduced_topology(cfg, resolution=None, model_channels=None):
    """Shrink a config for reduced-size runs and tests, keeping widths
    consistent (same rules as the JAX package's helper).

    ``resolution`` propagates to the condition encoder's ``feature_map_size``;
    ``model_channels`` overrides the UNet model/encoder/head channel widths
    (``base_channels`` of ``EfficientUNet`` and ``HDiT`` in the uncond and
    flow configs) and the layout encoder's ``output_dim`` (its pooled
    ``xf_proj`` adds onto the UNet's 4x-channels time embedding).  The v0
    stack (``layout_unet``) runs its encoder as wide as the UNet (hidden 256
    at production width), so there ``hidden_dim`` follows ``model_channels``
    too; v1-v6 keep their 64-wide encoder.
    """
    if resolution:
        cfg.data.resolution = tuple(resolution)
        if getattr(cfg, "condition_model", None) is not None:
            cfg.condition_model.params["feature_map_size"] = tuple(resolution)
    if model_channels:
        for key in ("model_channels", "encoder_channels", "num_head_channels", "base_channels"):
            if key in cfg.model.params:
                cfg.model.params[key] = model_channels
        if (
            getattr(cfg, "condition_model", None) is not None
            and "output_dim" in cfg.condition_model.params
        ):
            cfg.condition_model.params["output_dim"] = 4 * model_channels
            if cfg.model.architecture == "layout_unet":
                cfg.condition_model.params["hidden_dim"] = model_channels
    return cfg


def apply_override(cfg, spec: str) -> None:
    """``a.b.c=json`` → set that attribute or dict entry of the config,
    keeping a tuple field a tuple."""
    path, _, raw = spec.partition("=")
    value = json.loads(raw)
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
    leaf = parts[-1]
    old = obj[leaf] if isinstance(obj, dict) else getattr(obj, leaf, None)
    if isinstance(old, tuple) and isinstance(value, list):
        value = tuple(value)
    if isinstance(obj, dict):
        obj[leaf] = value
    else:
        setattr(obj, leaf, value)
