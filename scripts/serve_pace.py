#!/usr/bin/env python3
"""Eager serving pace of the PyTorch port on one card: seconds of B=8
DPM-Solver++(2M)@15 requests through ``CondFrameGenerator``
(``nuscenes-box-layout-v6``) and ``UncondFrameGenerator``
(``nuscenes-unet-uncond``), in the dtypes asked for, seeded weights, after
one warm-up request; with ``--rollouts N``, N 4D rollouts of the v6 /
auto-reg-v2 pair in bfloat16 (8 scenes, 1 + 7 frames, DPM++(2M)@15, the
``chip_smoke.py`` rollout) after a short warm-up; and the host time of the
kernel wrappers alone (one GroupNorm at the token shape (8, 13, 64), whose
kernel takes ~5 µs).

``--repo DIR`` imports ``lidarcrafter_tpu_torch`` from another checkout
(say a parent commit unpacked with ``git archive``), so that two versions
are compared within one call on one card: run parent and change in turn,
as parent, change, change, parent, ...  Prints one JSON line per (config,
dtype), one for the rollouts, then the wrapper line, then the card's
``nvidia-smi`` name and power limit.

Usage: ``python3 scripts/serve_pace.py [--repo DIR] [--rounds 3] [--dtypes float32 bfloat16] [--rollouts 0]``
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CONFIGS = ("nuscenes-box-layout-v6", "nuscenes-unet-uncond")
STEPS, BATCH = 15, 8
ROLLOUT_SCENES, ROLLOUT_FRAMES = 8, 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--rounds", type=int, default=3, help="timed requests per (config, dtype)")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"], choices=["float32", "bfloat16"])
    ap.add_argument("--rollouts", type=int, default=0, help="timed bfloat16 v6 rollouts")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.kernels import groupnorm, loader
    from lidarcrafter_tpu_torch.sample_temporal import RolloutGenerator

    if not torch.cuda.is_available():
        print("serve_pace: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loader.load_kernels()
    repo = str(Path(args.repo).resolve())
    for dname in args.dtypes:
        dtype = getattr(torch, dname)
        for name in CONFIGS:
            cls = UncondFrameGenerator if name == "nuscenes-unet-uncond" else CondFrameGenerator
            gen = cls(get_config(name), "cuda", 0, dtype)
            gen.generate(BATCH, STEPS, mode="dpmpp_2m", seed=99)
            seconds = []
            for i in range(args.rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen.generate(BATCH, STEPS, mode="dpmpp_2m", seed=i)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            print(json.dumps({"repo": repo, "config": name, "dtype": dname, "batch": BATCH, "steps": STEPS,
                              "request_seconds": seconds, "median_seconds": statistics.median(seconds),
                              "ms_per_call": 1e3 * statistics.median(seconds) / STEPS}), flush=True)
            del gen
            torch.cuda.empty_cache()
    if args.rollouts:
        gen = RolloutGenerator(get_config("nuscenes-box-layout-v6"), get_config("nuscenes-auto-reg-v2"),
                               "cuda", 0, torch.bfloat16, num_steps=2, mode="dpmpp_2m")
        gen.generate(ROLLOUT_SCENES, num_frames=1, seed=99)  # warm-up: 1 + 1 frames, 2 steps
        gen.pipeline.num_sampling_steps = STEPS
        seconds = []
        for i in range(args.rollouts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(ROLLOUT_SCENES, num_frames=ROLLOUT_FRAMES, seed=i, stream_chunks=2)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        calls = (ROLLOUT_FRAMES + 1) * STEPS
        print(json.dumps({"repo": repo, "rollout": "nuscenes-box-layout-v6 + nuscenes-auto-reg-v2",
                          "dtype": "bfloat16", "scenes": ROLLOUT_SCENES, "frames": ROLLOUT_FRAMES + 1,
                          "steps": STEPS, "rollout_seconds": seconds, "median_seconds": statistics.median(seconds),
                          "ms_per_call": 1e3 * statistics.median(seconds) / calls}), flush=True)
        del gen
        torch.cuda.empty_cache()
    # the wrapper's host time: a token-shape GroupNorm, timed on the host
    # over calls queued back to back (the card keeps up with the host here)
    x = torch.randn(8, 13, 64, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with torch.inference_mode():
        for _ in range(200):
            groupnorm.group_norm(x, w, b, num_groups=32, eps=1e-5, silu=True)
        torch.cuda.synchronize()
        n, t0 = 5000, time.perf_counter()
        for _ in range(n):
            groupnorm.group_norm(x, w, b, num_groups=32, eps=1e-5, silu=True)
        host_us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"repo": repo, "wrapper": "group_norm (8, 13, 64)", "host_us_per_call": host_us}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
