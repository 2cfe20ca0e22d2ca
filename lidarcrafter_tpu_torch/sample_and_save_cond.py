"""Eval-scale conditional sample-and-save.

Port of the JAX package's ``tools/sample_and_save_cond.py``: walk a dataset
split in order, build the condition streams as training does
(``condition_mask`` → concat condition, the normalised previous-frame
depth → autoregressive condition), sample the conditional stack in
fixed-size batches (the tail wraps onto the last item, as the reference's
``drop_last=False`` with fixed sample seeds) and save each frame as a
reference-format dump (5, H, W) = [depth, x, y, z, reflectance] named
``samples_{seed:07d}_{token}.pth``, scoreable by the port's and the JAX
package's eval CLIs.  ``--format txt`` writes point files instead;
``--synthetic N`` replaces the dataset with N zero-condition batches.
``--ckpt`` samples with a training checkpoint's EMA weights (else seeded
random weights).  Batch ``k`` draws from ``torch.Generator(device)``
seeded with ``seed + k`` (the JAX tool folds ``k`` into its key).  It runs
on the card unless ``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.sample_and_save_cond -c nuscenes-auto-reg-v2 --ckpt DIR \\
      --num-sample 10000 -b 8 --num-steps 256 --mode ddpm -o generated/our
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from .configs import apply_override, apply_reduced_topology, get_config
from .datasets import make_dataset
from .generate_cond import CondFrameGenerator
from .training.factory import layout_condition_batch
from .training.preprocess import postprocess_sample, preprocess_autoregressive_cond, preprocess_condition_mask
from .utils.sample_io import save_pth_sample


def synthetic_batches(cfg, n_total: int, batch_size: int, device):
    """``(batch, tokens)`` of zero conditions covering ``n_total`` frames."""
    for start in range(0, n_total, batch_size):
        yield (layout_condition_batch(cfg, batch_size, device=device),
               [f"synthetic{start + i}" for i in range(batch_size)])


def dataset_batches(cfg, ds, n_total: int, batch_size: int, lidar_utils, device):
    """``(batch, tokens)`` over the first ``n_total`` items of ``ds`` in
    order, in fixed-size batches whose tail repeats the last item; the
    condition streams are preprocessed as the trainer's
    ``prepare_batch`` does."""
    ncls = len(cfg.data.class_names)
    for start in range(0, n_total, batch_size):
        idx = [min(start + i, len(ds) - 1) for i in range(batch_size)]
        collated = ds.collate_fn([ds[j] for j in idx])
        batch = {k: torch.as_tensor(v).to(device) for k, v in collated.items() if isinstance(v, np.ndarray)}
        if "condition_mask" in batch:
            batch["concat_cond"] = preprocess_condition_mask(batch, lidar_utils, ncls)
        if "autoregressive_cond" in batch:
            batch["autoregressive_cond"] = preprocess_autoregressive_cond(
                batch["autoregressive_cond"], lidar_utils, include_reflectance=False)
        yield batch, list(collated.get("token", [f"idx{j:06d}" for j in idx]))


def sample_and_save(gen: CondFrameGenerator, batches, n_total: int, batch_size: int, num_steps: int,
                    mode: str, seed: int, out_dir: str | Path, fmt: str = "pth") -> int:
    """Sample each batch of ``batches`` and write its first frames up to
    ``n_total`` in all; returns the number written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = 0
    for step, (batch, toks) in enumerate(batches):
        sample, _ = gen.generate(batch_size, num_steps, mode=mode, seed=seed + step, batch=batch)
        post = postprocess_sample(sample.clamp(-1, 1), gen.lidar_utils)
        depth, xyz = post["depth"].cpu().numpy(), post["xyz"].cpu().numpy()
        refl = post["reflectance"].cpu().numpy() if "reflectance" in post else None
        for i in range(batch_size):
            if written >= n_total:
                break
            name = f"samples_{step * batch_size + i:07d}_{toks[i]}"
            if fmt == "pth":
                save_pth_sample(out_dir / f"{name}.pth", depth[i], xyz[i], None if refl is None else refl[i])
            else:
                pts = xyz[i].reshape(-1, 3)
                np.savetxt(out_dir / f"{name}.txt", pts[np.linalg.norm(pts, axis=1) > 1e-2], fmt="%.6f")
            written += 1
        print(f"saved {written}/{n_total}", file=sys.stderr, flush=True)
        if written >= n_total:
            break
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-auto-reg-v2")
    parser.add_argument("--ckpt", default=None, help="training checkpoint dir (its EMA weights)")
    parser.add_argument("-b", "--batch-size", type=int, default=8)
    parser.add_argument("--num-sample", type=int, default=10000)
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddpm")
    parser.add_argument("--split", default="all", help="dataset split (the reference samples 'all')")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--format", choices=["pth", "txt"], default="pth")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N")
    parser.add_argument("--resolution", type=int, nargs=2, default=None, help="override H W (smoke runs)")
    parser.add_argument("--model-channels", type=int, default=None, help="override widths (smoke runs)")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                        help="config override, e.g. data.data_root='\"/data/nuscenes\"'")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("-o", "--output", default="generated_results/our")
    args = parser.parse_args(argv)

    cfg = apply_reduced_topology(get_config(args.cfg), resolution=args.resolution,
                                 model_channels=args.model_channels)
    for spec in args.set:
        apply_override(cfg, spec)
    if getattr(cfg, "condition_model", None) is None:
        raise SystemExit(f"{args.cfg} is not a conditional config")
    if not args.ckpt:
        print("WARNING: no checkpoint - sampling from seeded random weights", file=sys.stderr)
    gen = CondFrameGenerator(cfg, device=args.device, weights_seed=args.seed, ckpt=args.ckpt)
    B = args.batch_size
    if args.synthetic:
        n_total = args.synthetic
        batches = synthetic_batches(cfg, n_total, B, gen.device)
    else:
        cfg.data.split = args.split
        ds = make_dataset(cfg, seed=args.seed)
        n_total = min(args.num_sample, len(ds))
        batches = dataset_batches(cfg, ds, n_total, B, gen.lidar_utils, gen.device)
    written = sample_and_save(gen, batches, n_total, B, args.num_steps, args.mode, args.seed, args.output,
                              args.format)
    print(f"wrote {written} samples -> {args.output}")


if __name__ == "__main__":
    main()
