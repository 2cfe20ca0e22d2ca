"""The metric suite over generated vs. reference clouds: the port's entry
point for ``metrics.evaluate``, with the JAX package's ``tools/evaluate.py``
flags and ``--device`` (CUDA unless asked for the CPU).

Usage::

  python -m lidarcrafter_tpu_torch.evaluate --real DIR --gen DIR -m cd jsd mmd [--device cpu]

Point files: ``.txt`` / ``.npy`` (N, ≥3), ``.bin`` packed float32 rows,
``.pth`` range-image dumps.  ``frid`` reads the pretrained RangeNet under
``--pretrained-root``, ``fsvd`` / ``fpvd`` its MinkowskiNet / SPVCNN
(``{root}/{dataset}/{minkowskinet,spvcnn}/model.ckpt``, torchsparse
state dicts) on at most ``--sparse-max-points`` points a cloud.
"""

from __future__ import annotations

import argparse
import json

import torch

from .metrics import evaluate
from .utils.sample_io import list_sample_files, load_point_file


def load_dir(d, limit=None) -> list:
    out = [load_point_file(f)[:, :3] for f in list_sample_files(d, limit)]
    if not out:
        raise SystemExit(f"no .txt/.npy/.bin/.pth point files found in {d}")
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--real", required=True)
    parser.add_argument("--gen", required=True)
    parser.add_argument("-m", "--metrics", nargs="+", default=["cd", "jsd", "mmd"])
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--data", default="32", choices=["32", "64"])
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--pretrained-root", default=None,
                        help="eval-backbone checkpoints dir ({root}/{dataset}/rangenet/ for frid, "
                             "minkowskinet/ and spvcnn/ for fsvd and fpvd)")
    parser.add_argument("--sparse-max-points", type=int, default=32768,
                        help="points a cloud (in the depth range) that fsvd/fpvd read")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions, as the reference computes them

    real = load_dir(args.real, args.limit)
    gen = load_dir(args.gen, args.limit)
    results = evaluate(real, gen, metrics=args.metrics, data=args.data,
                       pretrained_root=args.pretrained_root, max_points=args.sparse_max_points, device=args.device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
