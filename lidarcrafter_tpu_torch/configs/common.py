"""Shared config dataclasses: the port's own copy of the JAX package's
``configs/common.py`` (same field names and defaults)."""

from dataclasses import dataclass, field
from typing import Literal, Tuple

CLASS_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "motorcycle", "bicycle", "pedestrian",
)


@dataclass
class ModelConfig:
    architecture: str = "efficient_unet"
    params: dict = field(default_factory=dict)


@dataclass
class ConditionModelConfig:
    architecture: str = "identity"
    params: dict = field(default_factory=dict)


@dataclass
class DiffusionConfig:
    num_training_steps: int | None = None
    num_sampling_steps: int = 1024
    prediction_type: Literal["eps", "v", "x_0"] = "eps"
    loss_type: str = "l2"
    noise_schedule: str = "cosine"
    timestep_type: Literal["continuous", "discrete"] = "continuous"
    cond_mode: str | None = None
    w_loss_weight: bool = False
    clip_sample: bool = True


@dataclass
class FlowConfig:
    """cf. ``option_meanflow_nusc.py`` FlowConfig."""

    flow_type: Literal["mean", "mean_std"] = "mean"
    channels: int = 2
    image_size: Tuple[int, int] = (32, 1024)
    flow_ratio: float = 0.50
    normalizer: tuple = ("minmax", None, None)
    time_dist: tuple = ("lognorm", -0.4, 1)
    cfg_ratio: float = 0.10
    cfg_scale: float | None = None
    cfg_unconditional: str = "u"


@dataclass
class TrainingConfig:
    batch_size_train: int = 2
    batch_size_eval: int = 8
    num_workers: int = 4
    num_steps: int = 300_000
    steps_save_image: int = 5_000
    steps_save_model: int = 10_000
    gradient_accumulation_steps: int = 1
    lr: float = 1e-4
    lr_warmup_steps: int = 10_000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    adam_weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    ema_decay: float = 0.995
    ema_update_every: int = 10
    mixed_precision: str = "bf16"  # TPU-native; the reference uses fp16 AMP
    output_dir: str = "logs/diffusion"
    seed: int = 0


@dataclass
class DataConfig:
    dataset: str = "nuscenes"
    task: str | None = None
    class_names: Tuple[str, ...] = CLASS_NAMES
    custom_collate_fn: bool = False
    data_root: str = "../data/nuscenes"
    pkl_path: str | None = None
    depth_format: Literal["log_depth", "inverse_depth", "depth"] = "log_depth"
    scan_unfolding: bool = False
    projection: str = "spherical-1024"
    train_depth: bool = True
    train_reflectance: bool = True
    resolution: Tuple[int, int] = (32, 1024)
    min_depth: float = 1.45
    max_depth: float = 80.0
    fov_up: float = 10.0
    fov_down: float = -30.0
    split: str = "train"
    delete_ground: bool = False
    with_object: bool = False
    num_samples: int = 1024  # object branch point count
    # scene-graph CLIP feature cache root (reference layout:
    # ``nuscenes_dataset.py:28`` — '../data/clips/nuscenes')
    clip_cache_dir: str | None = "../data/clips/nuscenes"


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    condition_model: ConditionModelConfig | None = None
    flow: FlowConfig | None = None
