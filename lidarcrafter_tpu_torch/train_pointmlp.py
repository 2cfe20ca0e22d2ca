"""Train the PointMLP foreground-object classifier (the CGF backbone): the
port's counterpart of the JAX package's ``tools/train_pointmlp.py``, with
its flags and ``--device`` (CUDA unless asked for the CPU).

One epoch is one step, as there: label-smoothed cross-entropy, weight decay
then SGD with momentum 0.9 on a cosine decay from ``--lr`` to ``--min-lr``
(``training/classifier.py``), the BatchNorms on batch statistics and the
head's dropout at 0.5.  Data: the ``nuscenes-object`` dataset on
``--pkl-path`` (its box-normalised object clouds and classes), or with
``--synthetic-data`` a pool of 8 synthetic batches made at the start, the
points of each class drawn at a scale of its own (a source the classifier
can learn; the JAX CLI draws class-free noise).  The model is written as a
port checkpoint, ``{output}/ckpt_{epochs:010d}/`` (``state.pt`` +
``config.json``), which ``evaluate_our --pointmlp-ckpt`` reads.

Usage::

  python -m lidarcrafter_tpu_torch.train_pointmlp --synthetic-data --epochs 20 -o runs/pointmlp [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve_device

SYNTHETIC_POOL = 8  # batches the synthetic source cycles through


def synthetic_batches(batch_size: int, points: int, num_classes: int, rng: np.random.RandomState):
    """Cycle through a pool of batches whose class c has points of scale
    0.5 + 0.5·c along x and 1 / (1 + c) along z."""
    pool = []
    for _ in range(SYNTHETIC_POOL):
        labels = rng.randint(0, num_classes, batch_size)
        scale = np.stack([0.5 + 0.5 * labels, np.ones(batch_size), 1.0 / (1.0 + labels)], 1)[:, None]
        pool.append(((rng.randn(batch_size, points, 3) * scale).astype(np.float32), labels))
    while True:
        yield from pool


def dataset_batches(pkl_path, batch_size: int, rng: np.random.RandomState):
    from .configs import get_config
    from .datasets import NuscObjectDataset

    cfg = get_config("nuscenes-object")
    if pkl_path:
        cfg.data.pkl_path = pkl_path
    ds = NuscObjectDataset(cfg)
    while True:
        order = rng.permutation(len(ds))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [ds[j] for j in order[i : i + batch_size]]
            yield (np.stack([it["fg_points"][:, :3] for it in items]),
                   np.concatenate([it["fg_class"] for it in items]))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pkl-path", default=None, help="object db pkl (GT database)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--min-lr", type=float, default=0.005)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("-o", "--output", default="logs/pointmlp")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .metrics.extractor.pointmlp import point_mlp
    from .training.checkpoint import save_checkpoint
    from .training.classifier import make_classifier_optimizer, make_classifier_train_step
    from .training.state import TrainState

    rng = np.random.RandomState(args.seed)
    if args.synthetic_data:
        data = synthetic_batches(args.batch_size, args.points, args.num_classes, rng)
    else:
        data = dataset_batches(args.pkl_path, args.batch_size, rng)
    torch.manual_seed(args.seed)
    model = point_mlp(num_classes=args.num_classes, points=args.points).to(device)
    tx = make_classifier_optimizer(lr=args.lr, min_lr=args.min_lr, epochs=args.epochs, steps_per_epoch=1)
    opt_state = tx.init(list(model.parameters()))
    step = make_classifier_train_step(model, tx)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    losses, accs = [], []
    t0 = time.perf_counter()
    for i in range(args.epochs):
        pts, labels = next(data)
        batch = {"points": torch.as_tensor(pts, device=device), "labels": torch.as_tensor(labels, device=device)}
        loss, acc = step(opt_state, batch, gen)
        losses.append(float(loss))
        accs.append(float(acc))
        if i % 10 == 0 or i == args.epochs - 1:
            print(f"epoch {i}: loss={losses[-1]:.4f} acc={accs[-1]:.3f}", flush=True)
    train_seconds = time.perf_counter() - t0

    path = Path(args.output) / f"ckpt_{args.epochs:010d}"
    save_checkpoint(path, TrainState(step=args.epochs, models={"model": model}, ema={}, opt_state=opt_state),
                    {"num_classes": args.num_classes, "points": args.points})
    print(f"saved classifier to {path}")
    return {"losses": losses, "accs": accs, "checkpoint": str(path), "train_seconds": train_seconds}


if __name__ == "__main__":
    main()
