"""Where a float32 PointMLP train step parts from float64: a diagnostic.

One train step of a seeded full-width PointMLP (1,024 points, dropout off,
SGD at lr 0.1 as ``train_pointmlp``) on the first batch of that CLI's
synthetic source, in float64 and in float32 on one device.  It prints one
JSON object:

- ``batchnorm``: each train-mode BatchNorm's smallest batch variance beside
  its eps, and the largest ``(E[x]² + var) / var``, the factor by which
  flax's ``E[x²] − E[x]²`` multiplies the rounding of ``E[x²]``;
- ``fps_knn_differ``: FPS and kNN indices of every stage, float32 against
  float64;
- ``grad_max_abs_err``: the float32 gradients' largest error against
  float64 as the model runs, with float64's max-pool argmaxes replayed in
  the float32 backward, and with its ReLU masks replayed as well (both
  sides then route every max and every ReLU alike);
- ``update_rel_l2``: the float32 step's parameter update against float64's,
  ‖Δ32 − Δ64‖ / ‖Δ64‖.

Usage::

  python -m lidarcrafter_tpu_torch.step_precision [--batch 4] [--device cpu]

(CUDA unless asked for the CPU; about 8 GB of memory at 4 clouds.)
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from . import resolve_device


class Routes(TorchFunctionMode):
    """Takes every ``amax`` as a gather at one argmax, and every ``F.relu``
    as a product with a mask: recorded from the values (``replay=None``) or
    replayed in call order from another run's record."""

    def __init__(self, replay: list | None = None):
        super().__init__()
        self.record, self.replay = [], None if replay is None else list(replay)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.amax:
            x, dim = args[0], kwargs.get("dim", args[1] if len(args) > 1 else None)
            idx = self.replay.pop(0) if self.replay is not None else x.detach().argmax(dim)
            self.record.append(idx)
            return x.gather(dim, idx.unsqueeze(dim)).squeeze(dim)
        if func is F.relu and self.replay is not None and self.replay and self.replay[0].dtype == torch.bool:
            return args[0] * self.replay.pop(0).to(args[0].dtype)
        if func is F.relu:
            self.record.append(args[0].detach() > 0)
        return func(*args, **kwargs)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .metrics.extractor.pointmlp import LocalGrouper, point_mlp
    from .models.batch_norm import BatchNorm
    from .ops.points import farthest_point_sampling, knn
    from .train_pointmlp import synthetic_batches
    from .training.classifier import make_classifier_optimizer, make_classifier_train_step, smoothed_cross_entropy
    from .weights import init_random_

    device = resolve_device(args.device)
    pts, labels = next(synthetic_batches(args.batch, 1024, 4, np.random.RandomState(0)))
    labels = torch.as_tensor(labels, device=device)
    model0 = init_random_(point_mlp(4, dropout=0.0), 0).to(device)
    bn_rows, picks = [], {torch.float64: [], torch.float32: []}

    def bn_hook(mod, inp, out):
        if len(inp) < 2 or not inp[1]:  # eval-mode calls
            return
        x = inp[0].detach()
        mean = x.mean(tuple(range(x.ndim - 1)))
        var = ((x - mean) ** 2).mean(tuple(range(x.ndim - 1)))
        bn_rows.append({"min_var": float(var.min()), "eps": mod.eps,
                        "max_cancellation": float(((mean ** 2 + var) / var).max())})

    def grouper_hook(mod, inp, out):
        xyz = inp[0].detach()
        idx = farthest_point_sampling(xyz, mod.groups)
        new_xyz = xyz[torch.arange(len(xyz), device=device)[:, None], idx.long()]
        picks[xyz.dtype] += [idx, knn(new_xyz, xyz, min(mod.kneighbors, xyz.shape[1]))[1]]

    def grads(dtype, mode=None, hooks=False):
        m = copy.deepcopy(model0).to(dtype)
        if hooks:
            for mod in m.modules():
                if isinstance(mod, BatchNorm) and dtype == torch.float64:
                    mod.register_forward_hook(bn_hook)
                if isinstance(mod, LocalGrouper):
                    mod.register_forward_hook(grouper_hook)
        params = list(m.parameters())
        x = torch.as_tensor(pts, device=device).to(dtype)
        if mode is None:
            loss = smoothed_cross_entropy(m(x, train=True), labels)
        else:
            with mode:
                loss = smoothed_cross_entropy(m(x, train=True), labels)
        return [g.double() for g in torch.autograd.grad(loss, params)]

    def worst(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    g64 = grads(torch.float64, hooks=True)
    g32 = grads(torch.float32, hooks=True)
    record = Routes()
    r64 = grads(torch.float64, record)
    pools = [r for r in record.record if r.dtype != torch.bool]
    r32_pools = grads(torch.float32, Routes(pools))
    r32_both = grads(torch.float32, Routes(record.record))

    def update(dtype):
        m = copy.deepcopy(model0).to(dtype)
        tx = make_classifier_optimizer(epochs=20)
        make_classifier_train_step(m, tx)(tx.init(list(m.parameters())),
                                          {"points": torch.as_tensor(pts, device=device).to(dtype), "labels": labels})
        return [(a.detach().double() - b.detach().double()) for a, b in zip(m.parameters(), model0.parameters())]

    d64, d32 = update(torch.float64), update(torch.float32)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(d32, d64))
    den = sum(float((b ** 2).sum()) for b in d64)
    out = {
        "batch": args.batch, "device": str(device),
        "batchnorm": {"layers": len(bn_rows), "min_var": min(r["min_var"] for r in bn_rows), "eps": bn_rows[0]["eps"],
                      "max_cancellation": max(r["max_cancellation"] for r in bn_rows)},
        "fps_knn_differ": sum(int((a != b).sum()) for a, b in zip(picks[torch.float64], picks[torch.float32])),
        "fps_knn_indices": sum(a.numel() for a in picks[torch.float64]),
        "max_pools": len(pools),
        "grad_max": max(float(g.abs().max()) for g in g64),
        "grad_max_abs_err": {"as_run": worst(g32, g64), "max_pools_replayed": worst(r32_pools, r64),
                             "max_pools_and_relus_replayed": worst(r32_both, r64)},
        "update_rel_l2": (num / den) ** 0.5,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
