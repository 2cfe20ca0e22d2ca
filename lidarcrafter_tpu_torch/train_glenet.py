"""Train GLENet's uncertainty folds for RGF: the port's counterpart of the
JAX package's ``tools/train_glenet.py``, with its flags and ``--device``
(CUDA unless asked for the CPU).

Per KFold(10, shuffle, seed 42) fold of the car / truck / bus crops, the
CVAE trains at exp20 (reg + linearly annealed KL + 1e-4 · L2, AdamW on the
one-cycle LR from 0.003, clip 10, batch 64; ``metrics/models/glenet.py``)
and is written as a fold checkpoint ``{output}/fold_{i}/`` (``state.pt``
+ ``config.json``), which ``evaluate_our --glenet-fold-dir`` reads for its
30-pass evaluation.  Batches are fixed-size over reshuffled epochs, the
tail batch filled from the head of the same order, so every crop is seen
each epoch.  ``--synthetic-data N`` trains on N synthetic crops (the JAX
CLI's).

Usage::

  python -m lidarcrafter_tpu_torch.train_glenet --fg-info foreground_samples_info.pkl \\
      --text-feat obj_text_feat.pkl --epochs 400 -o logs/glenet_folds [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve_device


def linear_annealing(init, fin, step, annealing_steps):
    """From ``init`` to ``fin`` over ``annealing_steps``, then ``fin``."""
    if annealing_steps == 0:
        return fin
    delta = fin - init
    return min(init + delta * step / annealing_steps, fin)


def synthetic_infos(n: int, rng: np.random.RandomState):
    """``n`` crop records of 64 random points, with the CLIP table."""
    from .datasets.object_uncertainty import CLASS_NAMES

    infos = [
        {
            "name": CLASS_NAMES[i % len(CLASS_NAMES)],
            "num_points_in_gt": int(rng.randint(30, 600)),
            "box3d_lidar": np.array([*rng.randn(3), 4.0, 1.8, 1.6, rng.uniform(-3, 3)], np.float32),
            "points": rng.randn(64, 4).astype(np.float32),
        }
        for i in range(n)
    ]
    return infos, {c: rng.randn(1, 512).astype(np.float32) for c in CLASS_NAMES}


def fold_batches(ds, batch_size: int, rng: np.random.RandomState):
    """Fixed-size batches over reshuffled epochs, the tail filled from the
    head of the same order."""
    bs = min(batch_size, len(ds))
    while True:
        order = rng.permutation(len(ds))
        for start in range(0, len(order), bs):
            idx = order[start : start + bs]
            if len(idx) < bs:
                idx = np.concatenate([idx, order[: bs - len(idx)]])
            items = [ds[j] for j in idx]
            yield {k: np.stack([item[k] for item in items]) for k in items[0]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fg-info", default=None,
                   help="foreground_samples_info.pkl (class → records) or a flat list of records")
    p.add_argument("--text-feat", default=None, help="obj_text_feat.pkl {class: (1, 512)}")
    p.add_argument("--folds", default=None, help="comma list of fold indices (default: all 10)")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--steps-per-epoch", type=int, default=None, help="cap the steps of an epoch")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--point-dims", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-data", type=int, default=0, metavar="N", help="train on N synthetic crops")
    p.add_argument("-o", "--output", default="logs/glenet_folds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .datasets.object_uncertainty import ObjectUncertaintyDataset, flatten_uncertainty_infos
    from .metrics.models.glenet import (
        EXP20_KWARGS,
        GLENet,
        make_glenet_optimizer,
        make_glenet_train_step,
        save_glenet_fold,
    )

    rng = np.random.RandomState(args.seed)
    if args.synthetic_data:
        infos, text_feat = synthetic_infos(args.synthetic_data, rng)
    else:
        if not args.fg_info or not args.text_feat:
            raise SystemExit("--fg-info and --text-feat required (or --synthetic-data N)")
        with open(args.fg_info, "rb") as f:
            infos = pickle.load(f)
        with open(args.text_feat, "rb") as f:
            text_feat = pickle.load(f)
    infos = flatten_uncertainty_infos(infos)
    folds = [int(x) for x in args.folds.split(",")] if args.folds else range(10)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    history, seconds = {}, {}
    for fold_idx in folds:
        ds = ObjectUncertaintyDataset(infos, fold_idx, text_feat, training=True, point_dims=args.point_dims,
                                      rng=rng)
        spe = args.steps_per_epoch or max(-(-len(ds) // args.batch_size), 1)
        tx = make_glenet_optimizer(lr=args.lr, total_steps=spe * args.epochs)
        torch.manual_seed(args.seed)
        model = GLENet(**EXP20_KWARGS).to(device)
        opt_state = tx.init(list(model.parameters()))
        step = make_glenet_train_step(model, tx)
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed + fold_idx)
        batches = fold_batches(ds, args.batch_size, rng)
        rows = []
        t0 = time.perf_counter()
        for epoch in range(args.epochs):
            anneal = linear_annealing(0, 1, epoch + 1, args.epochs)
            for _ in range(spe):
                batch = {k: torch.as_tensor(v, device=device) for k, v in next(batches).items()}
                metrics = step(opt_state, batch, anneal, generator=gen)
                rows.append({k: float(v) for k, v in metrics.items()})
            if epoch % 50 == 0 or epoch == args.epochs - 1:
                print(f"fold {fold_idx} epoch {epoch}: loss={rows[-1]['loss']:.4f} reg={rows[-1]['reg']:.4f} "
                      f"latent={rows[-1]['latent']:.4f}", flush=True)
        seconds[fold_idx] = time.perf_counter() - t0
        path = out_dir / f"fold_{fold_idx}"
        save_glenet_fold(path, model, EXP20_KWARGS)
        print(f"saved {path}")
        history[fold_idx] = rows
    return {"history": history, "train_seconds": seconds}


if __name__ == "__main__":
    main()
