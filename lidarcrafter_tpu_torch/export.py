"""Export a sampler as a self-contained serving artifact.

Port of the JAX package's ``tools/export.py``: the whole sampler program
(condition encoder + N-step DDPM / DDIM / DPM-Solver++(2M) loop + range →
point postprocess, weights in it) is traced with ``torch.export`` and saved
by ``serving/export.py``; a serving host loads it with
``lidarcrafter_tpu_torch.serving.load_artifact`` and calls ``fn(seed)``, or
``fn(seed, condition)`` for a conditional config.  ``--ckpt`` reads one of
the port's training checkpoints (its online weights, ``--ema`` its EMA
weights; ``convert_checkpoint`` writes one from an upstream ``.pth``);
without it the weights are seeded random ones, as the generators draw them.
The artifact is traced on ``--device`` (the card by default) and keeps the
Hopper kernels as operators; one traced with ``--device cpu`` moves to the
card at load.

Usage::

  python -m lidarcrafter_tpu_torch.export -c nuscenes-unet-uncond [--ckpt DIR] -o art/ \\
      --batch 8 --num-steps 50 --mode ddim [--dtype bfloat16] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .configs import apply_reduced_topology, get_config
from .diffusion import ContinuousDiffusion
from .precision import DTYPES, to_serving_dtype_
from .serving import export_sampler, save_artifact
from .training.checkpoint import load_weights
from .training.factory import build_diffusion_training, layout_condition_batch
from .weights import init_random_


def build_serving_stack(cfg, device: str | torch.device, dtype: torch.dtype, ckpt: str | None = None,
                        ema: bool = False, weights_seed: int = 0):
    """``(engine, lidar_utils)`` of an image-diffusion config on ``device``,
    served in ``dtype``: the checkpoint's online (``ema``: EMA) weights, or
    the generators' seeded random ones (encoder ``weights_seed``, denoiser
    ``weights_seed + 1``; an unconditional model ``weights_seed``)."""
    built, engine, lidar_utils = build_diffusion_training(cfg, device)
    if not isinstance(engine, ContinuousDiffusion):
        raise ValueError(f"{type(engine).__name__}: only continuous-time configs export")
    models = built if isinstance(built, dict) else {"model": built}
    if ckpt:
        load_weights(ckpt, models, ema=ema)
    elif "cond" in models:
        init_random_(models["cond"], weights_seed)
        init_random_(models["model"], weights_seed + 1)
    else:
        init_random_(models["model"], weights_seed)
    to_serving_dtype_(models["model"], dtype, cond_model=models.get("cond"))
    return dataclasses.replace(engine, dtype=dtype), lidar_utils


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-unet-uncond")
    parser.add_argument("--ckpt", default=None, help="the port's training checkpoint dir")
    parser.add_argument("-o", "--output", default="exported_sampler")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--num-steps", type=int, default=50)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddim")
    parser.add_argument("--ema", action="store_true", help="the checkpoint's EMA weights")
    parser.add_argument("--dtype", choices=list(DTYPES), default="bfloat16",
                        help="precision of the model forward (the sampler stays float32)")
    parser.add_argument("--raw", action="store_true",
                        help="emit the raw [-1,1] sample instead of depth/xyz/reflectance")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs; checkpoints need the native resolution)")
    parser.add_argument("--model-channels", type=int, default=None, help="override widths (smoke runs)")
    parser.add_argument("--device", default="cuda", help="device the program is traced on")
    args = parser.parse_args(argv)

    cfg = apply_reduced_topology(get_config(args.cfg), resolution=args.resolution,
                                 model_channels=args.model_channels)
    if not args.ckpt:
        print("WARNING: no checkpoint - exporting seeded random weights")
    engine, lidar_utils = build_serving_stack(cfg, args.device, DTYPES[args.dtype], args.ckpt, args.ema)
    conditional = getattr(engine, "cond_model", None) is not None
    B = args.batch
    condition = layout_condition_batch(cfg, B, device=args.device) if conditional else None
    t0 = time.perf_counter()
    exported = export_sampler(engine, lidar_utils, batch_size=B, num_steps=args.num_steps, mode=args.mode,
                              with_postprocess=not args.raw, condition_example=condition)
    seconds = time.perf_counter() - t0
    out = save_artifact(args.output, exported, meta={
        "config": args.cfg, "batch_size": B, "num_steps": args.num_steps, "mode": args.mode,
        "dtype": args.dtype, "conditional": conditional, "postprocess": not args.raw,
        "sampling_shape": list(engine.sampling_shape),
        "condition_shapes": {k: list(v.shape) for k, v in (condition or {}).items()},
        "ckpt": args.ckpt or "", "ema": bool(args.ema), "export_seconds": seconds,
    })
    size = (out / "sampler.pt2").stat().st_size
    print(f"exported {args.cfg} -> {out} ({size / 1e6:.1f} MB, device={args.device}, {seconds:.1f} s)")


if __name__ == "__main__":
    main()
