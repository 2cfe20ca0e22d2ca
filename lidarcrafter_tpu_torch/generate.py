"""Unconditional single-frame generation: the port's entry point for
``nuscenes-unet-uncond``, ``kitti-360`` (64x1024) and
``nuscenes-hdit-uncond`` (HDiT).

Mirrors the JAX package's ``tools/generate.py``: unconditional sampling
(DDPM, DDIM or DPM-Solver++(2M); DDPM or DDIM over integer steps for a
config with ``timestep_type='discrete'``) and ``postprocess_sample``;
:meth:`UncondFrameGenerator.inpaint` serves RePaint requests.  It writes one
``sample_NNNN.txt`` point cloud (x, y, z, reflectance) per frame and
``samples.npy``.  ``--ckpt`` samples with the EMA weights of one of the
port's training checkpoints (``train.py``); without it the model runs with
seeded random weights.  ``--dtype bfloat16`` serves the model in
bf16, as the JAX package's ``build_sampler_fn`` does (the sampler stays
float32); the default is float32.

Usage::

  python -m lidarcrafter_tpu_torch.generate -c nuscenes-unet-uncond -n 8 \\
      --num-steps 50 --mode ddim [--dtype bfloat16]
  python -m lidarcrafter_tpu_torch.generate -c nuscenes-hdit-uncond -n 8 \\
      --num-steps 50 --mode ddim [--dtype bfloat16]

:class:`UncondFrameGenerator` holds a built model and answers requests;
:func:`generate` builds one and answers a single request.
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
from .training.factory import build_diffusion_training
from .training.preprocess import postprocess_sample
from .weights import init_random_


class UncondFrameGenerator:
    """The unconditional model of one config, built once on ``device`` with
    the EMA weights of the checkpoint ``ckpt`` (else random weights drawn
    from ``weights_seed``) and served in ``dtype``."""

    def __init__(
        self, cfg, device: str | torch.device = "cuda", weights_seed: int = 0,
        dtype: torch.dtype = torch.float32, ckpt: str | None = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model, engine, self.lidar_utils = build_diffusion_training(cfg, self.device)
        if ckpt:
            load_weights(ckpt, {"model": self.model})
        else:
            init_random_(self.model, weights_seed)
        to_serving_dtype_(self.model, dtype)
        self.engine = dataclasses.replace(engine, dtype=dtype)

    def generate(
        self,
        batch_size: int,
        num_steps: int,
        mode: str = "ddpm",
        seed: int = 0,
    ) -> tuple[torch.Tensor, dict]:
        """Sample ``batch_size`` frames; returns the [-1, 1] sample
        (B, H, W, C) and its postprocessed depth / xyz / reflectance."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.engine.sample(batch_size, num_steps, mode=mode, generator=generator)
        return sample, postprocess_sample(sample, self.lidar_utils)

    def inpaint(
        self,
        known: torch.Tensor,
        mask: torch.Tensor,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        seed: int = 0,
    ) -> tuple[torch.Tensor, dict]:
        """RePaint: complete the [-1, 1] frames ``known`` (B, H, W, C) where
        ``mask`` is 0, keeping them where it is 1 (a continuous-time config);
        returns the sample and its postprocessed depth / xyz / reflectance."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.engine.repaint(
            known.to(self.device), mask.to(self.device), num_steps, num_resample_steps, jump_length,
            generator=generator,
        )
        return sample, postprocess_sample(sample, self.lidar_utils)


def generate(
    cfg_name: str = "nuscenes-unet-uncond",
    num_samples: int = 8,
    num_steps: int = 256,
    mode: str = "ddpm",
    seed: int = 0,
    device: str | torch.device = "cuda",
    resolution: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.float32,
    ckpt: str | None = None,
) -> dict:
    """Build the model of ``cfg_name`` and sample ``num_samples`` frames;
    returns ``{'sample', 'depth', 'xyz', 'reflectance'}``."""
    cfg = apply_reduced_topology(get_config(cfg_name), resolution=resolution)
    gen = UncondFrameGenerator(cfg, device=device, weights_seed=seed, dtype=dtype, ckpt=ckpt)
    sample, post = gen.generate(num_samples, num_steps, mode=mode, seed=seed)
    return {"sample": sample, **post}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-unet-uncond")
    parser.add_argument("--ckpt", default=None, help="training checkpoint dir (its EMA weights)")
    parser.add_argument("-n", "--num-samples", type=int, default=8)
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddpm",
                        help="sampler (a discrete-time config takes ddpm or ddim)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=list(DTYPES), default="float32",
                        help="precision of the model forward (the sampler stays float32)")
    parser.add_argument("-o", "--output", default="generated")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs)")
    args = parser.parse_args(argv)
    out = generate(
        args.cfg, args.num_samples, args.num_steps, args.mode, args.seed,
        args.device, args.resolution, DTYPES[args.dtype], args.ckpt,
    )
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(args.num_samples):
        xyz = out["xyz"][i].reshape(-1, 3).cpu().numpy()
        refl = out["reflectance"][i].reshape(-1, 1).cpu().numpy()
        pts = np.concatenate([xyz, refl], axis=1)[np.linalg.norm(xyz, axis=1) > 1e-2]
        np.savetxt(out_dir / f"sample_{i:04d}.txt", pts, fmt="%.6f")
    np.save(out_dir / "samples.npy", out["sample"].cpu().numpy())
    print(f"wrote {args.num_samples} samples to {out_dir}")


if __name__ == "__main__":
    main()
