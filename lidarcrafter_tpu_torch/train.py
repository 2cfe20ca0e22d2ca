"""Train a named experiment: the port's counterpart of the JAX package's
``tools/train.py`` for the unconditional and the layout-conditioned configs.

Real nuScenes batches are not ported yet (the dataset is not in the
repository); ``--synthetic-data`` trains on generated batches.  For
``nuscenes-unet-uncond`` they are the JAX CLI's random range images
(uniform depth and reflectance); for the layout configs, which the JAX CLI
has no synthetic source for, they are the banded range images of
``utils/synthetic.py`` as x_0 with one random layout condition batch, as
the JAX package's ``bench.py::bench_solver_cert`` pairs them.  The trainer
runs on the card unless ``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.train -c nuscenes-box-layout-v6 \\
      --synthetic-data --num-steps 1000 --output-dir runs/v6 [--resume]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .configs import apply_reduced_topology, get_config
from .training.factory import layout_condition_batch
from .training.loop import Trainer
from .utils.synthetic import banded_range_image_batch


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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-unet-uncond")
    parser.add_argument("-b", "--batch-size", type=int, default=None)
    parser.add_argument("--num-steps", type=int, default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--synthetic-data", action="store_true",
                        help="train on generated batches: random range images for the uncond config; "
                             "banded range images with a random layout batch for the layout configs "
                             "(the JAX CLI has no synthetic source for those)")
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
                        help="override the layout UNet's channel width (smoke runs)")
    args = parser.parse_args(argv)

    cfg = apply_reduced_topology(get_config(args.cfg), resolution=args.resolution,
                                 model_channels=args.model_channels)
    if args.batch_size:
        cfg.training.batch_size_train = args.batch_size
    seed = cfg.training.seed if args.seed is None else args.seed
    if getattr(cfg, "flow", None) is not None:
        raise SystemExit("training the flow config (the JAX package's FlowTrainer) is not ported")
    if not args.synthetic_data:
        raise SystemExit("nuScenes data loading is not ported; train with --synthetic-data")
    if getattr(cfg, "condition_model", None) is None:
        data = synthetic_batches(cfg, seed)
    else:
        data = synthetic_layout_batches(cfg, seed, args.device)
    trainer = Trainer(cfg, data, output_dir=args.output_dir, device=args.device)
    trainer.train(num_steps=args.num_steps, seed=seed, checkpoint_every=args.checkpoint_every, resume=args.resume)


if __name__ == "__main__":
    main()
