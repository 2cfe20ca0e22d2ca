"""Train a named experiment: the port's counterpart of the JAX package's
``tools/train.py``, with its dispatch: a flow config trains with
``FlowTrainer`` (the MeanFlow loss), ``layout_generation`` with a
``unet_1d`` model with ``LayoutTrainer``, ``object_generation`` with
``ObjectTrainer`` and everything else with ``Trainer``.

Real nuScenes batches are not ported yet (the dataset is not in the
repository); ``--synthetic-data`` trains on generated batches.  For
``nuscenes-unet-uncond`` and ``meanflow-nusc`` they are the JAX CLI's random
range images (uniform depth and reflectance).  The JAX CLI has no synthetic
source for the other configs; here the layout-conditioned ones take the
banded range images of ``utils/synthetic.py`` as x_0 with one random layout
condition batch, as the JAX package's ``bench.py::bench_solver_cert`` pairs
them, ``nuscenes-layout`` synthetic scene graphs of ego + 12 objects a scene
and ``nuscenes-object`` the points of synthetic boxes (each source cycles
through a pool made at the start).  The object branch's CLIP class-text
table is ``--text-features`` (a pickle), zeros without it, as in the JAX
CLI.  The trainer runs on the card unless ``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.train -c nuscenes-box-layout-v6 \\
      --synthetic-data --num-steps 1000 --output-dir runs/v6 [--resume]
"""

from __future__ import annotations

import argparse
import itertools
import pickle

import numpy as np
import torch

from .configs import apply_reduced_topology, get_config
from .training.factory import layout_condition_batch
from .training.loop import FlowTrainer, LayoutTrainer, ObjectTrainer, Trainer
from .utils.synthetic import banded_range_image_batch, synthetic_object_points, synthetic_scene_graphs

LAYOUT_OBJECTS = 12  # objects a synthetic scene graph holds besides the ego (13 nodes)
POOL = 8  # distinct batches a scene-graph or object source cycles through


def synthetic_batches(cfg, seed: int):
    """Random range images as the JAX CLI's ``synthetic_batches``:
    depth uniform in [0, 60) m, reflectance uniform in [0, 1)."""
    H, W = cfg.data.resolution
    B = cfg.training.batch_size_train
    rng = np.random.RandomState(seed)
    while True:
        depth = rng.uniform(0, 60, (B, H, W, 1)).astype(np.float32)
        yield {"depth": depth, "reflectance": rng.rand(B, H, W, 1).astype(np.float32)}


def synthetic_layout_batches(cfg, seed: int, device: str | torch.device = "cpu"):
    """Banded x_0 (fresh each step) with one random layout condition batch."""
    H, W = cfg.data.resolution
    B = cfg.training.batch_size_train
    generator = torch.Generator(device=device).manual_seed(seed)
    cond = layout_condition_batch(cfg, B, generator=generator, device=device)
    while True:
        yield dict(cond, x_0=banded_range_image_batch(B, H, W, generator=generator, device=device))


def scene_graph_batches(cfg, seed: int):
    """``batch_size_train`` synthetic scene graphs of ego + 12 objects a
    batch, collated (``collate_scene_graphs``), from a pool of ``POOL``."""
    B = cfg.training.batch_size_train
    return itertools.cycle([synthetic_scene_graphs(B, LAYOUT_OBJECTS, seed=seed + i) for i in range(POOL)])


def object_batches(cfg, seed: int):
    """``batch_size_train`` synthetic objects a batch with their
    ``num_samples`` box-frame points, from a pool of ``POOL``."""
    B, P = cfg.training.batch_size_train, cfg.data.num_samples
    return itertools.cycle([synthetic_object_points(1, B, P, seed=seed + i) for i in range(POOL)])


def build_trainer(cfg, seed: int, device: str | torch.device = "cuda", text_features=None, **kw):
    """The trainer of ``cfg``'s branch (the JAX CLI's dispatch) over its
    synthetic source; ``kw`` goes to the trainer."""
    if getattr(cfg, "flow", None) is not None:
        return FlowTrainer(cfg, synthetic_batches(cfg, seed), device=device, **kw)
    task = cfg.data.task
    if task == "layout_generation" and cfg.model.architecture == "unet_1d":
        return LayoutTrainer(cfg, scene_graph_batches(cfg, seed), device=device, **kw)
    if task == "object_generation":
        if text_features is None:
            text_features = np.zeros((len(cfg.data.class_names), 512), np.float32)
        return ObjectTrainer(cfg, object_batches(cfg, seed), text_features, device=device, **kw)
    if getattr(cfg, "condition_model", None) is None:
        return Trainer(cfg, synthetic_batches(cfg, seed), device=device, **kw)
    return Trainer(cfg, synthetic_layout_batches(cfg, seed, device), device=device, **kw)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-unet-uncond")
    parser.add_argument("-b", "--batch-size", type=int, default=None)
    parser.add_argument("--num-steps", type=int, default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="train on generated batches: random range images for the uncond and flow configs; "
                             "banded range images with a random layout batch for the layout-conditioned configs, "
                             "synthetic scene graphs for nuscenes-layout, synthetic box points for nuscenes-object "
                             "(the JAX CLI has no synthetic source for those)")
    parser.add_argument("--text-features", default=None,
                        help="CLIP class-text table pickle, (num_class, 512) (object branch; zeros without it)")
    parser.add_argument("--resume", nargs="?", const="auto", default=None,
                        help="resume from a checkpoint dir, or (no value) the newest ckpt_* in "
                             "--output-dir; restores weights, EMA, optimizer and step")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="steps between checkpoints (default: the config's steps_save_model)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=None, help="default: the config's training seed")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs)")
    parser.add_argument("--model-channels", type=int, default=None,
                        help="override the UNets' channel width (smoke runs)")
    args = parser.parse_args(argv)

    cfg = apply_reduced_topology(get_config(args.cfg), resolution=args.resolution,
                                 model_channels=args.model_channels)
    if args.batch_size:
        cfg.training.batch_size_train = args.batch_size
    seed = cfg.training.seed if args.seed is None else args.seed
    if not args.synthetic_data:
        raise SystemExit("nuScenes data loading is not ported; train with --synthetic-data")
    text = None
    if args.text_features:
        with open(args.text_features, "rb") as f:
            text = pickle.load(f)
    trainer = build_trainer(cfg, seed, args.device, text, output_dir=args.output_dir)
    trainer.train(num_steps=args.num_steps, seed=seed, checkpoint_every=args.checkpoint_every, resume=args.resume)


if __name__ == "__main__":
    main()
