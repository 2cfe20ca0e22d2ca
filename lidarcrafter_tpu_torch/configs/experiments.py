"""The experiment configs the port runs.

An own copy of every config function of the JAX package's ``configs/experiments.py``,
field for field the same values: ``nuscenes-unet-uncond``, ``kitti-360``,
``nuscenes-hdit-uncond`` and ``meanflow-nusc`` for unconditional frames, the
``nuscenes-box-layout`` family (v0 and v1-v6) for layout-conditioned frames,
``nuscenes-auto-reg`` / ``-v2`` for autoregressive frames,
``nuscenes-layout`` for scene graph → 4D layout and ``nuscenes-object`` for
per-object points.  The ``option_nusc_box_layout_v*`` family is written as
deltas over the shared v2 base.
"""

from .common import (
    ConditionModelConfig,
    DataConfig,
    DiffusionConfig,
    ExperimentConfig,
    FlowConfig,
    ModelConfig,
    TrainingConfig,
)


def _efficient_unet_params():
    return {
        "base_channels": 64,
        "temb_channels": None,
        "channel_multiplier": (1, 2, 4, 8),
        "num_residual_blocks": (3, 3, 3, 3),
        "gn_num_groups": 8,
        "gn_eps": 1e-6,
        "attn_num_heads": 8,
        "coords_encoding": "fourier_features",
        "ring": True,
    }


def nusc_unet_uncond() -> ExperimentConfig:
    """cf. ``option_unet_nusc.py`` (nuscenes-unet-uncond)."""
    return ExperimentConfig(
        data=DataConfig(),
        model=ModelConfig("efficient_unet", _efficient_unet_params()),
        diffusion=DiffusionConfig(),
        training=TrainingConfig(),
    )


def kitti_360() -> ExperimentConfig:
    """cf. ``option_kitti.py`` (kitti-360): 64x1024 range images."""
    cfg = nusc_unet_uncond()
    cfg.data.dataset = "kitti_360"
    cfg.data.resolution = (64, 1024)
    cfg.data.fov_up, cfg.data.fov_down = 3.0, -25.0
    return cfg


def meanflow_nusc() -> ExperimentConfig:
    """cf. ``option_meanflow_nusc.py`` (meanflow-nusc)."""
    return ExperimentConfig(
        data=DataConfig(),
        model=ModelConfig("mf_efficient_unet", _efficient_unet_params()),
        diffusion=DiffusionConfig(),  # unused by the flow engine
        flow=FlowConfig(),
        training=TrainingConfig(steps_save_model=50_000),
    )


def nusc_hdit_uncond() -> ExperimentConfig:
    """cf. ``option_dit_nusc.py`` (nuscenes-hdit-uncond)."""
    return ExperimentConfig(
        data=DataConfig(),
        model=ModelConfig(
            "hdit",
            {
                "base_channels": 128,
                "time_embed_channels": 256,
                "depths": (3, 3, 3, 3),
                "dilation": (1, 1, 1, 1),
                "positional_embedding": "learnable_embedding",
                "ring": True,
            },
        ),
        diffusion=DiffusionConfig(),
        training=TrainingConfig(),
    )


def _layout_unet_v1_params(out_channels=2):
    """cf. ``option_nusc_auto_reg_v2.py`` / ``option_nusc_box_layout_v2.py``."""
    return {
        "image_size": 32,
        "use_scale_shift_norm": True,
        "out_channels": out_channels,
        "model_channels": 64,
        "encoder_channels": 64,
        "num_head_channels": 32,
        "num_heads": -1,
        "num_heads_upsample": -1,
        "num_res_blocks": 2,
        "num_attention_blocks": 1,
        "resblock_updown": True,
        "attention_ds": (4, 8),
        "channel_mult": (1, 2, 4, 8),
        "dropout": 0.1,
        "use_positional_embedding_for_attention": True,
        "attention_block_type": "ObjectAwareCrossAttention",
    }


def _layout_encoder_params(out_channels=10):
    return {
        "feature_map_size": (32, 1024),
        "used_condition_types": ("obj_class", "obj_bbox", "is_valid_obj"),
        "layout_length": 13,
        "num_classes_for_layout_object": 9,
        "mask_size_for_layout_object": 32,
        "hidden_dim": 64,
        "output_dim": 256,
        "num_layers": 6,
        "num_heads": 4,
        "use_final_ln": True,
        "use_positional_embedding": False,
        "not_use_layout_fusion_module": False,
        "resolution_to_attention": (4, 8),
        "use_key_padding_mask": False,
        "out_channels": out_channels,
    }


def _box_layout_base(out_channels=10, num_steps=300_000) -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(task="layout_cond", custom_collate_fn=True,
                        pkl_path="../data/infos/nuscenes_infos_lidargen_train.pkl"),
        model=ModelConfig("layout_unet_v1", _layout_unet_v1_params()),
        condition_model=ConditionModelConfig(
            "layout_encoder", _layout_encoder_params(out_channels)
        ),
        diffusion=DiffusionConfig(cond_mode="concat"),
        training=TrainingConfig(num_steps=num_steps, steps_save_model=50_000),
    )


def nusc_box_layout() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout.py`` (v0): the faithful ``LayoutUnet`` —
    plain convs, ADM resampling, channel_mult (1,1,2), attention at ds=4
    only, and no concat conditioning (that config's DiffusionConfig has no
    ``cond_mode``: the layout enters through cross-attention and
    ``xf_proj`` alone)."""
    cfg = _box_layout_base()
    cfg.model.architecture = "layout_unet"
    cfg.model.params.update(
        model_channels=256, encoder_channels=256, num_head_channels=64,
        attention_ds=(4,), channel_mult=(1, 1, 2),
    )
    # the encoder at production width (option_nusc_box_layout.py:31-51)
    cfg.condition_model.params.update(
        hidden_dim=256, output_dim=1024, num_heads=8,
        resolution_to_attention=(1, 2, 4),
    )
    cfg.condition_model.params.pop("out_channels", None)
    cfg.diffusion.cond_mode = None
    return cfg


def nusc_box_layout_v1() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v1.py`` — r2dm coords + encoder fix."""
    return _box_layout_base()


def nusc_box_layout_v2() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v2.py`` — obj_bbox_embedding fix + fg mask."""
    return _box_layout_base()


def nusc_box_layout_v3() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v3.py`` — with gt-sampling data augments."""
    cfg = _box_layout_base()
    cfg.data.with_object = True  # gt-paste augmentation enabled
    return cfg


def nusc_box_layout_v4() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v4.py`` — condition-mask loss weight."""
    cfg = _box_layout_base()
    cfg.diffusion.w_loss_weight = True
    return cfg


def nusc_box_layout_v5() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v5.py`` — layout_encoder_v5 + loss weight."""
    cfg = _box_layout_base()
    cfg.condition_model.architecture = "layout_encoder_v5"
    cfg.diffusion.w_loss_weight = True
    return cfg


def nusc_box_layout_v6() -> ExperimentConfig:
    """cf. ``option_nusc_box_layout_v6.py`` — no ground, 500k steps."""
    cfg = _box_layout_base(num_steps=500_000)
    cfg.data.delete_ground = True
    cfg.training.steps_save_model = 100_000
    return cfg


def nusc_auto_reg() -> ExperimentConfig:
    """cf. ``option_nusc_auto_reg.py`` — autoregressive, encoder out 12ch."""
    cfg = _box_layout_base(out_channels=12, num_steps=500_000)
    cfg.data.task = "autoregressive_generation"
    return cfg


def nusc_auto_reg_v2() -> ExperimentConfig:
    """cf. ``option_nusc_auto_reg_v2.py`` — multi-history cond, 11ch encoder."""
    cfg = _box_layout_base(out_channels=11, num_steps=500_000)
    cfg.data.task = "autoregressive_generation"
    return cfg


# ------------------------------------------------------------- layout (1D) / object


def nusc_layout() -> ExperimentConfig:
    """cf. ``option_nusc_layout.py`` (nuscenes-layout): UNet1D + SceneGraph."""
    return ExperimentConfig(
        data=DataConfig(task="layout_generation", custom_collate_fn=True,
                        pkl_path="../data/infos/nuscenes_infos_lidargen_train.pkl"),
        model=ModelConfig(
            "unet_1d",
            {
                "in_channels": 20,
                "out_channels": 20,
                "model_channels": 512,
                "channel_mult": (1, 1, 1, 1),
                "num_res_blocks": 2,
                "attention_resolutions": (4, 2),
                "num_heads": 8,
                "use_spatial_transformer": True,
                "transformer_depth": 1,
                "conditioning_key": "crossattn",
                "concat_dim": 1280,
                "crossattn_dim": 1280,
                "enable_t_emb": True,
            },
        ),
        condition_model=ConditionModelConfig(
            "scene_graph",
            {
                "embedding_dim": 64,
                "gconv_pooling": "avg",
                "gconv_num_layers": 5,
                "mlp_normalization": "batch",
                "separated": True,
                "replace_latent": True,
                "residual": True,
                "use_angles": True,
                "use_clip": True,
            },
        ),
        diffusion=DiffusionConfig(clip_sample=False),
        training=TrainingConfig(steps_save_model=50_000),
    )


def nusc_object() -> ExperimentConfig:
    """cf. ``option_nusc_object.py`` (nuscenes-object): per-object point diffusion."""
    return ExperimentConfig(
        data=DataConfig(
            task="object_generation", dataset="nuscenes-object",
            custom_collate_fn=True, num_samples=1024,
            pkl_path="../data/infos/nuscenes_dbinfos_10sweeps_withvelo.pkl",
        ),
        model=ModelConfig("point_unet", {"point_dim": 4, "cond_dims": 768}),
        condition_model=ConditionModelConfig("object_gen_encoder", {"num_class": 8}),
        diffusion=DiffusionConfig(clip_sample=False),
        training=TrainingConfig(num_steps=1_000_000, steps_save_model=100_000),
    )
