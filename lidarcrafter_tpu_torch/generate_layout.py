"""Scene graph → 4D layout (boxes + trajectories): the port's entry point
for ``nuscenes-layout``.

Mirrors the JAX package's ``tools/generate_layout.py``: the decoder side of
a collated scene-graph batch (``--graphs``, a pickle of
``collate_scene_graphs``' output) or ``--synthetic S`` scenes of
``--objects`` objects (``utils/synthetic.py``) goes through the
``SceneGraph`` encoder once, then ``UNet1DModel`` samples the flat (N, 20)
node batch with DDPM (the JAX tool's sampler) or DDIM.  Writes the JAX
tool's pickle: ``{'boxes', 'trajs'}`` from ``unscale_boxes_3d`` of the flat
batch (which zeroes its first row only) and the ``raw`` (N, 20) sample.
The stack runs in float32, with the EMA weights of a ``train.py`` checkpoint
(``--ckpt``, running statistics included) or seeded random weights.

Usage::

  python -m lidarcrafter_tpu_torch.generate_layout --synthetic 8 \\
      --num-steps 256 [--mode ddim] [--device cpu]

:class:`LayoutGenerator` holds a built stack and answers requests.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from . import resolve_device
from .configs import apply_reduced_topology, get_config
from .datasets.transforms import unscale_boxes_3d
from .training.checkpoint import load_weights
from .training.factory import build_layout_training
from .utils.synthetic import synthetic_scene_graphs
from .weights import init_random_


def layout_request(batch: dict, device: str | torch.device) -> dict:
    """The sampler's input from the decoder side of a collated batch
    (numpy arrays): ``boxes``, ``scene_ids`` and the ``scenegraph``."""
    dec = batch["decoder"]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return {
        "boxes": t(dec["boxes"]),
        "scene_ids": t(dec["obj_to_scene"]),
        "scenegraph": {"objs": t(dec["objs"]), "triples": t(dec["tripltes"]),
                       "text_feats": t(dec["text_feats"]), "rel_feats": t(dec["rel_feats"])},
    }


class LayoutGenerator:
    """The ``SceneGraph`` + ``UNet1DModel`` stack of one config, built once
    on ``device`` in float32, with the EMA weights of the checkpoint
    ``ckpt`` (else random weights drawn from ``weights_seed``)."""

    def __init__(self, cfg, device: str | torch.device = "cuda", weights_seed: int = 0, ckpt: str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.models, self.engine, _ = build_layout_training(cfg, self.device)
        if ckpt:
            load_weights(ckpt, self.models)
        else:
            init_random_(self.models["cond"], weights_seed)
            init_random_(self.models["model"], weights_seed + 1)

    def generate(self, batch: dict, num_steps: int, mode: str = "ddpm", seed: int = 0) -> torch.Tensor:
        """Sample the (N, 20) scaled boxes + trajectories of the collated
        scene-graph ``batch``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.engine.sample(layout_request(batch, self.device), num_steps, mode=mode, generator=generator)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-layout")
    parser.add_argument("--ckpt", default=None, help="layout training checkpoint dir (its EMA weights)")
    graphs = parser.add_mutually_exclusive_group(required=True)
    graphs.add_argument("--graphs", help="pickled collated scene-graph batch (decoder side is sampled)")
    graphs.add_argument("--synthetic", type=int, metavar="S", help="S synthetic scene graphs")
    parser.add_argument("--objects", type=int, default=12, help="objects per synthetic scene (plus the ego)")
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim"], default="ddpm")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--model-channels", type=int, default=None, help="override the UNet width (smoke runs)")
    parser.add_argument("-o", "--output", default="generated_layouts.pkl")
    args = parser.parse_args(argv)
    cfg = apply_reduced_topology(get_config(args.cfg), model_channels=args.model_channels)
    gen = LayoutGenerator(cfg, device=args.device, weights_seed=args.seed, ckpt=args.ckpt)
    if args.synthetic:
        batch = synthetic_scene_graphs(args.synthetic, args.objects, seed=args.seed)
    else:
        with open(args.graphs, "rb") as f:
            batch = pickle.load(f)
    raw = gen.generate(batch, args.num_steps, mode=args.mode, seed=args.seed).cpu().numpy()
    boxes, trajs = unscale_boxes_3d(raw)
    with open(args.output, "wb") as f:
        pickle.dump({"boxes": boxes, "trajs": trajs, "raw": raw}, f)
    print(f"wrote {len(boxes)} layout nodes to {args.output}")


if __name__ == "__main__":
    main()
