"""Box + class → per-object point cloud: the port's entry point for
``nuscenes-object``.

Mirrors the JAX package's ``tools/generate_object.py``: the condition
(``--boxes``, a pickle of ``{'fg_encoding_box', 'fg_class',
'fg_text_features'}``, or ``--synthetic S``, the objects of S synthetic
scenes of ``--objects`` objects, ``utils/synthetic.py``) goes through
``ObjectGenEncoder`` once, then ``PointUNet`` samples one (1024, 4)
box-frame cloud per object with DDPM (the JAX tool's sampler), DDIM or
DPM-Solver++(2M).  Writes the JAX tool's pickle: the raw (B, 1024, 4)
clouds.  The stack runs in float32, with the EMA weights of a ``train.py``
checkpoint (``--ckpt``) or seeded random weights.  No kernel of the port runs on this path:
it is Linears and pointwise ops.

Usage::

  python -m lidarcrafter_tpu_torch.generate_object --synthetic 8 \\
      --num-steps 256 [--mode ddim] [--device cpu]

:class:`ObjectGenerator` holds a built stack and answers requests.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from . import resolve_device
from .configs import get_config
from .training.checkpoint import load_weights
from .training.factory import build_object_training
from .utils.synthetic import synthetic_object_boxes
from .weights import init_random_


class ObjectGenerator:
    """The ``ObjectGenEncoder`` + ``PointUNet`` stack of one config, built
    once on ``device`` in float32, with the EMA weights of the checkpoint
    ``ckpt`` (else random weights drawn from ``weights_seed``)."""

    def __init__(self, cfg, device: str | torch.device = "cuda", weights_seed: int = 0, ckpt: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.models, self.engine, _ = build_object_training(cfg, self.device)
        init_random_(self.models["cond"], weights_seed)
        init_random_(self.models["model"], weights_seed + 1)
        if ckpt:
            load_weights(ckpt, self.models)

    def generate(self, boxes: dict, num_steps: int, mode: str = "ddpm", seed: int = 0) -> torch.Tensor:
        """Sample one (num_samples, point_dim) cloud per object of ``boxes``
        (numpy or torch ``fg_encoding_box``, ``fg_class``,
        ``fg_text_features``)."""
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in boxes.items()}
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.engine.sample(batch, batch_size=batch["fg_class"].shape[0], num_steps=num_steps, mode=mode,
                                  generator=generator)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-object")
    parser.add_argument("--ckpt", default=None, help="object training checkpoint dir (its EMA weights)")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--boxes", help="pickle with {'fg_encoding_box', 'fg_class', 'fg_text_features'}")
    source.add_argument("--synthetic", type=int, metavar="S", help="the objects of S synthetic scenes")
    parser.add_argument("--objects", type=int, default=12, help="objects per synthetic scene")
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddpm")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("-o", "--output", default="generated_objects.pkl")
    args = parser.parse_args(argv)
    gen = ObjectGenerator(get_config(args.cfg), device=args.device, weights_seed=args.seed, ckpt=args.ckpt)
    if args.synthetic:
        boxes = synthetic_object_boxes(args.synthetic, args.objects, seed=args.seed)
    else:
        with open(args.boxes, "rb") as f:
            boxes = pickle.load(f)
    out = gen.generate(boxes, args.num_steps, mode=args.mode, seed=args.seed).cpu().numpy()
    with open(args.output, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(out)} object clouds to {args.output}")


if __name__ == "__main__":
    main()
