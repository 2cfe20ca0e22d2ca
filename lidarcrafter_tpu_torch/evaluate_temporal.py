"""Sequence-level TTCE / TCD over saved 4D rollouts: the port's entry point
for ``metrics.temporal``, with the JAX package's
``tools/evaluate_temporal.py`` flags and ``--device`` (CUDA unless asked
for the CPU).

The input is one directory per sequence of per-frame clouds
(``frame_###.txt`` / ``.npy``, as ``sample_temporal`` writes them).  TTCE
needs per-frame calibration infos (``--infos``: a pkl of a list per
sequence, or a dict by sequence name); TCD runs on the clouds alone with
``--global-frame``, else it moves every frame into frame 0's coordinates
with the infos' ground-truth transforms.

Usage::

  python -m lidarcrafter_tpu_torch.evaluate_temporal --gen-dir out/rollouts -m tcd --global-frame [--device cpu]
  python -m lidarcrafter_tpu_torch.evaluate_temporal --gen-dir out/rollouts -m ttce tcd --infos infos.pkl
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from . import resolve_device
from .metrics.temporal import relative_gt_transform, sequence_tcd, sequence_ttce


def load_cloud(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path)[:, :3].astype(np.float32)
    return np.loadtxt(path)[:, :3].astype(np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gen-dir", required=True, help="directory of per-sequence subdirectories")
    p.add_argument("-m", "--metrics", nargs="+", default=["tcd"], choices=["ttce", "tcd"])
    p.add_argument("--infos", default=None, help="pkl of per-sequence infos")
    p.add_argument("--global-frame", action="store_true",
                   help="clouds are already in one global frame (TCD direct)")
    p.add_argument("--splits", type=int, nargs="+", default=None)
    p.add_argument("--max-points", type=int, default=16384)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    seq_dirs = sorted(d for d in Path(args.gen_dir).iterdir() if d.is_dir())
    if args.limit:
        seq_dirs = seq_dirs[: args.limit]
    if not seq_dirs:
        raise SystemExit(f"no sequence directories under {args.gen_dir}")

    infos_all = None
    if args.infos:
        with open(args.infos, "rb") as f:
            infos_all = pickle.load(f)

    rng = np.random.default_rng(0)

    def subsample(c):
        if len(c) > args.max_points:
            c = c[rng.choice(len(c), args.max_points, replace=False)]
        return c

    agg = {m: {} for m in args.metrics}
    for si, seq in enumerate(seq_dirs):
        files = sorted(list(seq.glob("frame_*.txt")) + list(seq.glob("frame_*.npy")))
        frames = [subsample(load_cloud(f)) for f in files]
        infos = None
        if infos_all is not None:
            infos = infos_all[seq.name] if isinstance(infos_all, dict) else infos_all[si]

        if "ttce" in args.metrics:
            if infos is None:
                raise SystemExit("ttce requires --infos")
            res = sequence_ttce(frames, infos, splits=tuple(args.splits or (3, 4)), device=device)
            for s, v in res.items():
                agg["ttce"].setdefault(s, []).extend(v)

        if "tcd" in args.metrics:
            if args.global_frame or infos is None:
                glob = frames
            else:
                # compose the ground-truth ego transforms into frame 0's coordinates
                glob = [frames[0]]
                for i in range(1, len(frames)):
                    R, t = relative_gt_transform(infos[i], infos[0])
                    glob.append(frames[i] @ R.T + t)
            res = sequence_tcd(glob, splits=tuple(args.splits or (1, 2, 3, 4)), device=device)
            for s, v in res.items():
                agg["tcd"].setdefault(s, []).extend(v)
        print(f"[{si + 1}/{len(seq_dirs)}] {seq.name}: {len(frames)} frames")

    out = {m: {f"split_{s}": float(np.mean(v)) for s, v in d.items() if v} for m, d in agg.items()}
    print(json.dumps(out, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
