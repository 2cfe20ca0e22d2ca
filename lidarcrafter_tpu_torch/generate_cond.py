"""Layout-conditioned single-frame generation: the port's serving entry point.

Mirrors the JAX package's ``tools/generate_cond.py`` in its ``--synthetic``
branch: zero layout conditions, conditional sampling (DDPM, DDIM or
DPM-Solver++(2M)) and ``postprocess_sample``, for every layout-conditioned
config: ``nuscenes-box-layout`` (v0) through ``-v6`` and
``nuscenes-auto-reg`` / ``-v2``.  ``-v5``'s encoder reads per-object box
encodings and the class text table (``fg_encoding_box``,
``fg_text_features``), which no synthetic request carries (the JAX tool's
``--synthetic`` fails on it too): the CLI refuses it, and a caller serves it
through :meth:`CondFrameGenerator.generate` with a batch of its own.
Without ``--ckpt`` the stack runs with seeded random weights.
``--dtype bfloat16`` serves the stack in bf16, as the JAX package's
``build_sampler_fn`` does (the sampler stays float32); the default is
float32.  ``--ckpt`` samples with the EMA weights of one of the port's
training checkpoints (``train.py``).

Usage::

  python -m lidarcrafter_tpu_torch.generate_cond -c nuscenes-box-layout-v6 \\
      --synthetic -n 8 --num-steps 50 --mode ddim [--dtype bfloat16]

:class:`CondFrameGenerator` holds a built stack and answers requests;
:func:`generate_cond` builds one and answers a single request.
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
from .training.factory import build_diffusion_training, layout_condition_batch
from .training.preprocess import postprocess_sample
from .weights import init_random_


class CondFrameGenerator:
    """The layout-conditioned stack of one config, built once on ``device``
    with the EMA weights of the checkpoint ``ckpt`` (else random weights
    drawn from ``weights_seed``) and served in ``dtype``."""

    def __init__(
        self, cfg, device: str | torch.device = "cuda", weights_seed: int = 0,
        dtype: torch.dtype = torch.float32, ckpt: str | None = None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        models, engine, self.lidar_utils = build_diffusion_training(cfg, self.device)
        if ckpt:
            load_weights(ckpt, models)
        else:
            init_random_(models["cond"], weights_seed)
            init_random_(models["model"], weights_seed + 1)
        to_serving_dtype_(models["model"], dtype, cond_model=models["cond"])
        self.models = models
        self.engine = dataclasses.replace(engine, dtype=dtype)

    def generate(
        self,
        batch_size: int,
        num_steps: int,
        mode: str = "ddpm",
        seed: int = 0,
        batch: dict | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Sample ``batch_size`` frames from the condition ``batch`` (a
        caller-built condition dict on the generator's device, as the JAX
        engine's ``sample(params, rng, batch, ...)`` takes it) or, without
        one, from the synthetic zero conditions of
        :func:`layout_condition_batch`; returns the [-1, 1] sample (B, H, W,
        C) and its postprocessed depth / xyz / reflectance."""
        if batch is None:
            check_synthetic(self.cfg)
            batch = layout_condition_batch(self.cfg, batch_size, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sample = self.engine.sample(
            batch, batch_size=batch_size, num_steps=num_steps, mode=mode, generator=generator
        )
        return sample, postprocess_sample(sample, self.lidar_utils)


def check_synthetic(cfg) -> None:
    """Raise for a config whose encoder needs inputs that the synthetic
    condition batch does not carry (the v5 encoder's)."""
    if cfg.condition_model.architecture == "layout_encoder_v5":
        raise ValueError(
            "nuscenes-box-layout-v5's encoder reads fg_encoding_box (B, L, 8) and fg_text_features (9, 512), "
            "which no synthetic request carries; pass a condition batch to CondFrameGenerator.generate"
        )


def generate_cond(
    cfg_name: str = "nuscenes-box-layout-v6",
    num_samples: int = 1,
    num_steps: int = 256,
    mode: str = "ddpm",
    seed: int = 0,
    device: str | torch.device = "cuda",
    resolution: tuple[int, int] | None = None,
    dtype: torch.dtype = torch.float32,
    ckpt: str | None = None,
) -> dict:
    """Build the stack of ``cfg_name`` and sample ``num_samples`` frames from
    synthetic conditions; returns ``{'sample', 'depth', 'xyz', ...}``.
    Raises ``ValueError`` for ``nuscenes-box-layout-v5`` (see
    :func:`check_synthetic`)."""
    cfg = apply_reduced_topology(get_config(cfg_name), resolution=resolution)
    gen = CondFrameGenerator(cfg, device=device, weights_seed=seed, dtype=dtype, ckpt=ckpt)
    sample, post = gen.generate(num_samples, num_steps, mode=mode, seed=seed)
    return {"sample": sample, **post}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-box-layout-v6")
    parser.add_argument("--synthetic", action="store_true",
                        help="zero layout conditions (the only source ported so far)")
    parser.add_argument("--ckpt", default=None, help="training checkpoint dir (its EMA weights)")
    parser.add_argument("-n", "--num-samples", type=int, default=1)
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddpm")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=list(DTYPES), default="float32",
                        help="precision of the model forward (the sampler stays float32)")
    parser.add_argument("-o", "--output", default="generated_cond")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs)")
    args = parser.parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic conditions are ported so far")
    try:
        check_synthetic(get_config(args.cfg))
    except ValueError as e:
        raise SystemExit(str(e)) from None
    out = generate_cond(
        args.cfg, args.num_samples, args.num_steps, args.mode, args.seed,
        args.device, args.resolution, DTYPES[args.dtype], args.ckpt,
    )
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(args.num_samples):
        xyz = out["xyz"][i].reshape(-1, 3).cpu().numpy()
        keep = np.linalg.norm(xyz, axis=1) > 1e-2
        np.savetxt(out_dir / f"cond_sample_{i:04d}.txt", xyz[keep], fmt="%.6f")
        np.save(out_dir / f"cond_sample_{i:04d}_depth.npy", out["depth"][i].cpu().numpy())
    print(f"wrote {args.num_samples} conditional samples -> {out_dir}")


if __name__ == "__main__":
    main()
