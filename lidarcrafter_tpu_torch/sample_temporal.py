"""4D sequence rollout: the port's counterpart of the JAX package's
``tools/sample_temporal.py``.

Builds the layout-conditioned stack (frame 0) and the autoregressive stack
(the frames after it) with the EMA weights of the port's training
checkpoints (``--cond-ckpt`` / ``--autoreg-ckpt``, from ``train.py``) or,
for a stack without one, seeded random weights, rolls
each scene 1 + N frames with :class:`~.pipeline.TemporalRollout` and writes
each frame's points as ``seq_XXXX/frame_XXX.txt``.  Scenes come from a
pickle (``--scenes``: a list of dicts with ``batch``, ``gt_fut_trajs``,
``boxes0`` and ``box_classes``, as the JAX tool reads) or are synthetic
(``--synthetic S``: S scenes of 4 boxes drawn from a seed, as the JAX
package's ``bench.py::bench_rollout`` draws them, with zero layout
conditions).  ``--dtype bfloat16`` serves both denoisers in bf16; the
geometry and the sampler stay float32.

Usage::

  python -m lidarcrafter_tpu_torch.sample_temporal --synthetic 8 \\
      --num-frames 15 --num-steps 15 --mode dpmpp_2m [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .configs import apply_reduced_topology, get_config
from .generate_cond import CondFrameGenerator
from .pipeline import TemporalRollout
from .precision import DTYPES
from .training.factory import layout_condition_batch
from .training.preprocess import postprocess_sample


def synthetic_scenes(num_scenes: int, num_boxes: int = 4, seed: int = 0):
    """``num_scenes`` scenes as ``bench_rollout`` draws them: per-agent
    future deltas (S, K+1, 6, 2) in [0, 0.5), boxes (S, K, 7) within 15 m
    of the ego, classes 1..K."""
    S, K = num_scenes, num_boxes
    r = np.random.RandomState(seed)
    trajs = (r.rand(S, K + 1, 6, 2) * 0.5).astype(np.float32)
    boxes0 = np.concatenate(
        [r.rand(S, K, 2) * 30 - 15, r.rand(S, K, 1) * 2 - 1,
         1 + r.rand(S, K, 3) * 3, r.rand(S, K, 1) * 3],
        axis=2,
    ).astype(np.float32)
    classes = np.tile(np.arange(1, K + 1, dtype=np.float32), (S, 1))
    return trajs, boxes0, classes


class RolloutGenerator:
    """Both stacks built once on ``device`` with the EMA weights of
    ``cond_ckpt`` / ``autoreg_ckpt`` or, without one, random weights from
    ``weights_seed`` (frame-0 stack: seeds w, w+1; autoregressive: w+2,
    w+3), served in ``dtype``, behind one :class:`TemporalRollout`."""

    def __init__(
        self,
        cond_cfg,
        autoreg_cfg,
        device: str | torch.device = "cuda",
        weights_seed: int = 0,
        dtype: torch.dtype = torch.float32,
        num_steps: int = 256,
        mode: str = "ddpm",
        cond_ckpt: str | None = None,
        autoreg_ckpt: str | None = None,
    ):
        self.device = resolve_device(device)
        self.cond = CondFrameGenerator(cond_cfg, self.device, weights_seed, dtype, ckpt=cond_ckpt)
        self.autoreg = CondFrameGenerator(autoreg_cfg, self.device, weights_seed + 2, dtype, ckpt=autoreg_ckpt)
        self.pipeline = TemporalRollout(
            cond_engine=self.cond.engine, autoreg_engine=self.autoreg.engine,
            lidar_utils=self.autoreg.lidar_utils, num_sampling_steps=num_steps,
            sampling_mode=mode, device=self.device,
        )

    @property
    def lidar_utils(self):
        return self.pipeline.lidar_utils

    def generate(
        self,
        num_scenes: int,
        num_frames: int = 15,
        seed: int = 0,
        interp_M: int | None = 16,
        fetch: bool = True,
        stream_chunks: int = 1,
    ) -> list:
        """Roll ``num_scenes`` synthetic scenes (drawn from ``seed``) with
        zero layout conditions; the starting noise comes from ``seed`` too."""
        trajs, boxes0, classes = synthetic_scenes(num_scenes, seed=seed)
        batch = layout_condition_batch(self.cond.cfg, num_scenes, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.pipeline.rollout(
            batch, trajs, boxes0, classes, generator, num_frames=num_frames,
            interp_M=interp_M, fetch=fetch, stream_chunks=stream_chunks,
        )


def write_sequence(seq_dir: Path, frames: list, scene: int, lidar_utils) -> None:
    """Scene ``scene`` of each (S, H, W, C) frame → ``frame_XXX.txt`` points
    (depth > 0)."""
    seq_dir.mkdir(parents=True, exist_ok=True)
    for fi, frame in enumerate(frames):
        post = postprocess_sample(torch.as_tensor(frame[scene : scene + 1]).cpu(), lidar_utils)
        xyz = post["xyz"][0].reshape(-1, 3).numpy()
        keep = np.linalg.norm(xyz, axis=1) > 1e-2
        np.savetxt(seq_dir / f"frame_{fi:03d}.txt", xyz[keep], fmt="%.6f")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cond-cfg", default="nuscenes-box-layout-v6")
    parser.add_argument("--autoreg-cfg", default="nuscenes-auto-reg-v2")
    parser.add_argument("--cond-ckpt", default=None, help="frame-0 stack's training checkpoint (EMA weights)")
    parser.add_argument("--autoreg-ckpt", default=None,
                        help="autoregressive stack's training checkpoint (EMA weights)")
    scenes = parser.add_mutually_exclusive_group(required=True)
    scenes.add_argument("--scenes", help="pickle: list of first-frame batches with gt_fut_trajs/boxes")
    scenes.add_argument("--synthetic", type=int, metavar="S",
                        help="S synthetic scenes of 4 boxes, zero layout conditions, rolled as one batch")
    parser.add_argument("--num-frames", type=int, default=15)
    parser.add_argument("--num-steps", type=int, default=256)
    parser.add_argument("--mode", choices=["ddpm", "ddim", "dpmpp_2m"], default="ddpm")
    parser.add_argument("--interp", type=int, default=16)
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W for reduced-size runs; scene batch maps must match")
    parser.add_argument("--model-channels", type=int, default=None,
                        help="override both stacks' UNet model/encoder channel width")
    parser.add_argument("--stream-chunks", type=int, default=2,
                        help="copy each of N chunks of frames to the host while the next computes")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=list(DTYPES), default="float32",
                        help="precision of the denoiser calls (geometry and sampler stay float32)")
    parser.add_argument("-o", "--output", default="temporal_points")
    args = parser.parse_args(argv)

    def config(name):
        return apply_reduced_topology(get_config(name), resolution=args.resolution,
                                      model_channels=args.model_channels)

    gen = RolloutGenerator(
        config(args.cond_cfg), config(args.autoreg_cfg), device=args.device,
        weights_seed=args.seed, dtype=DTYPES[args.dtype], num_steps=args.num_steps, mode=args.mode,
        cond_ckpt=args.cond_ckpt, autoreg_ckpt=args.autoreg_ckpt,
    )
    rollout = dict(num_frames=args.num_frames, interp_M=args.interp, stream_chunks=args.stream_chunks)
    out_root = Path(args.output)
    if args.synthetic:
        frames = gen.generate(args.synthetic, seed=args.seed, **rollout)
        runs = [(s, s, frames) for s in range(args.synthetic)]
    else:
        with open(args.scenes, "rb") as f:
            scene_list = pickle.load(f)
        generator = torch.Generator(device=gen.device).manual_seed(args.seed)
        runs = [
            (si, 0, gen.pipeline.rollout(
                scene["batch"], scene["gt_fut_trajs"], scene["boxes0"], scene["box_classes"],
                generator, **rollout,
            ))
            for si, scene in enumerate(scene_list)
        ]
    for si, s, frames in runs:
        seq_dir = out_root / f"seq_{si:04d}"
        write_sequence(seq_dir, frames, s, gen.lidar_utils)
        print(f"scene {si}: wrote {len(frames)} frames to {seq_dir}")


if __name__ == "__main__":
    main()
