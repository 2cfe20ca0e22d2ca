"""One-step MeanFlow generation: the port's entry point for ``meanflow-nusc``.

Mirrors the JAX package's ``tools/generate_flow.py``: one MeanFlow step from
noise, clamped to [-1, 1] as the reference does, then ``postprocess_sample``;
writes ``flow_sample_NNNN.txt`` (x, y, z) and ``flow_sample_NNNN_depth.npy``
per frame.  ``--ckpt`` samples with the online weights of a ``train.py``
checkpoint, or with its EMA weights under ``--ema``, as the JAX tool does;
without it the model runs with seeded random weights.  ``--dtype bfloat16``
serves the model in bf16 (the step itself stays float32); the default is
float32.

Usage::

  python -m lidarcrafter_tpu_torch.generate_flow -c meanflow-nusc -n 8 [--dtype bfloat16]

:class:`FlowFrameGenerator` holds a built model and answers requests;
:func:`generate_flow` builds one and answers a single request.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .configs import apply_reduced_topology, get_config
from .precision import DTYPES, to_serving_dtype_
from .training.checkpoint import load_weights
from .training.factory import build_flow_training
from .training.preprocess import postprocess_sample
from .weights import init_random_


class FlowFrameGenerator:
    """The MeanFlow model of one config, built once on ``device`` with the
    weights of the checkpoint ``ckpt`` (its EMA weights if ``ema``, else its
    online ones) or random weights drawn from ``weights_seed``, and served
    in ``dtype``."""

    def __init__(
        self, cfg, device: str | torch.device = "cuda", weights_seed: int = 0,
        dtype: torch.dtype = torch.float32, ckpt: str | None = None, ema: bool = False,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model, engine, self.lidar_utils = build_flow_training(cfg, self.device)
        init_random_(self.model, weights_seed)
        if ckpt:
            load_weights(ckpt, {"model": self.model}, ema=ema)
        to_serving_dtype_(self.model, dtype)
        self.engine = dataclasses.replace(engine, dtype=dtype)

    def generate(self, batch_size: int, seed: int = 0) -> tuple[torch.Tensor, dict]:
        """One-step sample of ``batch_size`` frames, clamped to [-1, 1], and
        its postprocessed depth / xyz / reflectance."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.engine.sample(batch_size, generator=generator).clamp(-1.0, 1.0)
        return sample, postprocess_sample(sample, self.lidar_utils)


def generate_flow(
    cfg_name: str = "meanflow-nusc",
    num_samples: int = 8,
    seed: int = 0,
    device: str | torch.device = "cuda",
    resolution: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.float32,
    ckpt: str | None = None,
    ema: bool = False,
    model_channels: int | None = None,
) -> dict:
    """Build the model of ``cfg_name`` (weights from ``ckpt`` as
    :class:`FlowFrameGenerator` takes them) and sample ``num_samples``
    frames; returns ``{'sample', 'depth', 'xyz', 'reflectance'}``."""
    cfg = apply_reduced_topology(get_config(cfg_name), resolution=resolution, model_channels=model_channels)
    gen = FlowFrameGenerator(cfg, device=device, weights_seed=seed, dtype=dtype, ckpt=ckpt, ema=ema)
    sample, post = gen.generate(num_samples, seed=seed)
    return {"sample": sample, **post}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="meanflow-nusc")
    parser.add_argument("-n", "--num-samples", type=int, default=8)
    parser.add_argument("--ckpt", default=None, help="training checkpoint dir (its online weights)")
    parser.add_argument("--ema", action="store_true", help="sample with the checkpoint's EMA weights")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=list(DTYPES), default="float32",
                        help="precision of the model forward (the step stays float32)")
    parser.add_argument("-o", "--output", default="generated_flow")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs)")
    parser.add_argument("--model-channels", type=int, default=None,
                        help="override the model width (smoke runs; must match --ckpt)")
    args = parser.parse_args(argv)
    out = generate_flow(args.cfg, args.num_samples, args.seed, args.device, args.resolution,
                        DTYPES[args.dtype], args.ckpt, args.ema, args.model_channels)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(args.num_samples):
        xyz = out["xyz"][i].reshape(-1, 3).cpu().numpy()
        keep = np.linalg.norm(xyz, axis=1) > 1e-2
        np.savetxt(out_dir / f"flow_sample_{i:04d}.txt", xyz[keep], fmt="%.6f")
        np.save(out_dir / f"flow_sample_{i:04d}_depth.npy", out["depth"][i].cpu().numpy())
    print(f"wrote {args.num_samples} flow samples -> {out_dir}")


if __name__ == "__main__":
    main()
