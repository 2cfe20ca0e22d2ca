"""Train RangeNet on nuScenes lidarseg range images: the port's counterpart
of the JAX package's ``tools/train_rangenet.py``, with its flags and
``--device`` (CUDA unless asked for the CPU).

SGD with momentum and weight decay on a warmup / exponential-decay LR,
inverse-frequency class weights with the void class 0 at zero (void pixels
ignored), mIoU every ``--eval-every`` steps (``training/segmentation.py``).
RangeNet reads its BatchNorm statistics and trains them as weights, as the
JAX trainer does.  Data: ``NuscSegDataset`` on ``--info`` under
``--data-root``, or with ``--synthetic-data`` a pool of 4 synthetic
batches of uniform range images whose labels follow the depth channel (a
source the network can learn; the JAX CLI draws labels independent of the
image).  The model is written as a port checkpoint,
``{output-dir}/ckpt_{num_steps:010d}/``.

Usage::

  python -m lidarcrafter_tpu_torch.train_rangenet --synthetic-data --num-steps 20 [--backbone 21] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve_device

SYNTHETIC_POOL = 4


def synthetic_batches(B, H, W, num_classes):
    """Cycle through a pool of (B, 5, H, W) uniform images, each pixel
    labelled by the bin of its depth channel (classes 1..num_classes−1)."""
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(SYNTHETIC_POOL):
        img = rng.rand(B, 5, H, W).astype(np.float32)
        labels = (1 + np.minimum(img[:, 0] * (num_classes - 1), num_classes - 2)).astype(np.int64)
        pool.append((img, labels))
    while True:
        yield from pool


def real_batches(info, data_root, B, H, W, rng):
    from .datasets.seg_dataset import NuscSegDataset

    ds = NuscSegDataset(info, data_root, resolution=(H, W))
    while True:
        order = rng.permutation(len(ds))
        for i in range(0, len(order) - B + 1, B):
            batch = ds.collate_fn([ds[j] for j in order[i : i + B]])
            yield ds.rangenet_input(batch), batch["segment"].astype(np.int64)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--info", default=None)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--backbone", type=int, default=53, choices=[21, 53])
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--num-steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--w-decay", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--lr-decay", type=float, default=0.9995)
    p.add_argument("--resolution", type=int, nargs=2, default=(32, 1024))
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--output-dir", default="runs/rangenet")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from .datasets.seg_dataset import NUM_SEG_CLASSES
    from .metrics.extractor.rangenet import RangeNet
    from .training.checkpoint import save_checkpoint
    from .training.segmentation import (
        make_rangenet_optimizer,
        make_segmentation_train_step,
        mean_iou,
        rangenet_class_weights,
        train_frozen_statistics_,
        trained_tensors,
    )
    from .training.state import TrainState

    H, W = args.resolution
    torch.manual_seed(0)
    model = RangeNet(num_classes=NUM_SEG_CLASSES, backbone=args.backbone).to(device)
    train_frozen_statistics_(model)
    tx = make_rangenet_optimizer(lr=args.lr, momentum=args.momentum, weight_decay=args.w_decay,
                                 warmup_steps=args.warmup_steps, decay=args.lr_decay)
    opt_state = tx.init(trained_tensors(model))
    # void (empty pixels, unlabeled) carries weight 0
    step_fn = make_segmentation_train_step(model, tx, rangenet_class_weights(NUM_SEG_CLASSES).to(device),
                                           ignore_index=0)
    if args.synthetic_data:
        data = synthetic_batches(args.batch_size, H, W, NUM_SEG_CLASSES)
    else:
        data = real_batches(args.info, args.data_root, args.batch_size, H, W, np.random.RandomState(0))

    def to_device(img, labels):
        return torch.as_tensor(img, device=device), torch.as_tensor(labels, device=device)

    losses, mious = [], []
    t0 = time.perf_counter()
    for step in range(1, args.num_steps + 1):
        img, labels = to_device(*next(data))
        losses.append(float(step_fn(opt_state, {"image": img, "labels": labels})))
        if step % 50 == 0 or step <= 2:
            print({"step": step, "loss": losses[-1]}, flush=True)
        if step % args.eval_every == 0:
            img, labels = to_device(*next(data))
            with torch.no_grad():
                mious.append(float(mean_iou(model(img), labels, NUM_SEG_CLASSES, ignore_index=0)))
            print({"step": step, "miou": mious[-1]}, flush=True)
    train_seconds = time.perf_counter() - t0
    path = Path(args.output_dir) / f"ckpt_{args.num_steps:010d}"
    save_checkpoint(path, TrainState(step=args.num_steps, models={"model": model}, ema={}, opt_state=opt_state),
                    {"num_classes": NUM_SEG_CLASSES, "backbone": args.backbone, "resolution": [H, W]})
    print("done")
    return {"losses": losses, "mious": mious, "checkpoint": str(path), "train_seconds": train_seconds}


if __name__ == "__main__":
    main()
