"""Train a named experiment: the port's counterpart of the JAX package's
``tools/train.py``, with its dispatch: a flow config trains with
``FlowTrainer`` (the MeanFlow loss), ``layout_generation`` with a
``unet_1d`` model with ``LayoutTrainer``, ``object_generation`` with
``ObjectTrainer`` and everything else with ``Trainer``.

By default it trains from nuScenes-format files, as the JAX CLI does: the
registry's dataset for ``cfg.data.dataset`` (``datasets/``) on the info
pickle ``cfg.data.pkl_path`` under ``cfg.data.data_root`` (``--set
data.data_root='"DIR"'`` and ``--set data.pkl_path='"FILE"'`` point them
elsewhere), loaded by ``PrefetchLoader`` on ``--workers`` threads (0: on
the training thread) in one seeded shuffled stream.  The layout task
collates scene graphs with ``collate_scene_graphs``; their CLIP features
come from the ``CLIP_%07d.pkl`` cache under ``cfg.data.clip_cache_dir`` or
from the CLIP text tower of ``--clip-ckpt`` / ``--clip-bpe``.

``--synthetic-data`` trains on generated batches instead.  For
``nuscenes-unet-uncond`` and ``meanflow-nusc`` they are the JAX CLI's random
range images (uniform depth and reflectance).  The JAX CLI has no synthetic
source for the other configs; here the layout-conditioned ones take the
banded range images of ``utils/synthetic.py`` as x_0 with one random layout
condition batch, as the JAX package's ``bench.py::bench_solver_cert`` pairs
them, ``nuscenes-layout`` synthetic scene graphs of ego + 12 objects a scene
and ``nuscenes-object`` the points of synthetic boxes (each source cycles
through a pool made at the start).  The object branch's CLIP class-text
table is ``--text-features`` (a pickle), zeros without it, as in the JAX
CLI.  The trainer runs on the card unless ``--device cpu``.

``--log-dir`` writes the tracker's ``events.jsonl`` and, every
``training.steps_save_image`` steps, DDIM previews of
``diffusion.num_sampling_steps`` steps on the EMA weights as PNGs (``--set``
either; ``training.steps_save_image=0``: none); ``--profile-dir`` a
``torch.profiler`` trace of steps 4-6.
Under ``torchrun --nproc-per-node N`` the run is data-parallel
(``parallel/ddp.py``): the global batch stays ``batch_size_train`` (``-b``),
each process trains on its rows of it, and rank 0 logs and checkpoints.

Usage::

  python -m lidarcrafter_tpu_torch.train -c nuscenes-auto-reg-v2 \\
      --set data.data_root='"data/nuscenes"' --set data.pkl_path='"data/infos/train.pkl"' \\
      --num-steps 1000 --output-dir runs/ar --log-dir runs/ar/log [--resume]
  torchrun --nproc-per-node 4 -m lidarcrafter_tpu_torch.train -c nuscenes-box-layout-v6 -b 8 ...
  python -m lidarcrafter_tpu_torch.train -c nuscenes-box-layout-v6 --synthetic-data --num-steps 1000
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle

import numpy as np
import torch

from .configs import apply_override, apply_reduced_topology, get_config
from .datasets import make_dataset
from .datasets.loader import PrefetchLoader
from .datasets.scene_graph import collate_scene_graphs
from .parallel.ddp import DataParallel
from .training.factory import layout_condition_batch
from .training.loop import FlowTrainer, LayoutTrainer, ObjectTrainer, Trainer
from .training.tracker import JsonlTracker
from .utils.synthetic import banded_range_image_batch, synthetic_object_points, synthetic_scene_graphs

LAYOUT_OBJECTS = 12  # objects a synthetic scene graph holds besides the ego (13 nodes)
POOL = 8  # distinct batches a scene-graph or object source cycles through


def synthetic_batches(cfg, seed: int):
    """Random range images as the JAX CLI's ``synthetic_batches``:
    depth uniform in [0, 60) m, reflectance uniform in [0, 1)."""
    H, W = cfg.data.resolution
    B = cfg.training.batch_size_train
    rng = np.random.RandomState(seed)
    while True:
        depth = rng.uniform(0, 60, (B, H, W, 1)).astype(np.float32)
        yield {"depth": depth, "reflectance": rng.rand(B, H, W, 1).astype(np.float32)}


def synthetic_layout_batches(cfg, seed: int, device: str | torch.device = "cpu"):
    """Banded x_0 (fresh each step) with one random layout condition batch."""
    H, W = cfg.data.resolution
    B = cfg.training.batch_size_train
    generator = torch.Generator(device=device).manual_seed(seed)
    cond = layout_condition_batch(cfg, B, generator=generator, device=device)
    while True:
        yield dict(cond, x_0=banded_range_image_batch(B, H, W, generator=generator, device=device))


def scene_graph_batches(cfg, seed: int):
    """``batch_size_train`` synthetic scene graphs of ego + 12 objects a
    batch, collated (``collate_scene_graphs``), from a pool of ``POOL``."""
    B = cfg.training.batch_size_train
    return itertools.cycle([synthetic_scene_graphs(B, LAYOUT_OBJECTS, seed=seed + i) for i in range(POOL)])


def object_batches(cfg, seed: int):
    """``batch_size_train`` synthetic objects a batch with their
    ``num_samples`` box-frame points, from a pool of ``POOL``."""
    B, P = cfg.training.batch_size_train, cfg.data.num_samples
    return itertools.cycle([synthetic_object_points(1, B, P, seed=seed + i) for i in range(POOL)])


def file_batches(cfg, seed: int, workers: int = 2, parallel: DataParallel | None = None,
                 text_encode_fn=None):
    """Collated batches of the registry's dataset for ``cfg`` (this rank's
    rows of each under ``parallel``), from ``PrefetchLoader`` on ``workers``
    threads.  The layout task collates scene graphs, re-encoding an edited
    relationship with ``text_encode_fn``; the dataset's assigner takes it
    for the features its cache lacks."""
    ds = make_dataset(cfg, seed=seed)
    collate = None
    if cfg.data.task == "layout_generation":
        ds.scene_graph_assigner.text_encode_fn = text_encode_fn
        if text_encode_fn is None:
            print("WARNING: no text_encode_fn on the dataset's scene-graph assigner — edited relationships "
                  "keep pre-edit CLIP features")

        def collate(items):
            return collate_scene_graphs(items, text_encode_fn=text_encode_fn)

    rank, world = (0, 1) if parallel is None else (parallel.rank, parallel.world)
    return iter(PrefetchLoader(ds, cfg.training.batch_size_train, collate=collate, num_workers=workers, seed=seed,
                               rank=rank, world=world))


def trainer_class(cfg):
    """The JAX CLI's dispatch: the trainer of ``cfg``'s branch."""
    if getattr(cfg, "flow", None) is not None:
        return FlowTrainer
    task = cfg.data.task
    if task == "layout_generation" and cfg.model.architecture == "unet_1d":
        return LayoutTrainer
    if task == "object_generation":
        return ObjectTrainer
    return Trainer


def synthetic_source(cfg, seed: int, device: str | torch.device = "cpu"):
    """The branch's generated batches (``--synthetic-data``)."""
    cls = trainer_class(cfg)
    if cls is LayoutTrainer:
        return scene_graph_batches(cfg, seed)
    if cls is ObjectTrainer:
        return object_batches(cfg, seed)
    if cls is FlowTrainer or getattr(cfg, "condition_model", None) is None:
        return synthetic_batches(cfg, seed)
    return synthetic_layout_batches(cfg, seed, device)


def build_trainer(cfg, seed: int, device: str | torch.device = "cuda", text_features=None, data=None, **kw):
    """The trainer of ``cfg``'s branch over ``data`` (collated batches), or
    over its synthetic source when None; ``kw`` goes to the trainer."""
    cls = trainer_class(cfg)
    if data is None:
        data = synthetic_source(cfg, seed, device)
    if cls is ObjectTrainer:
        if text_features is None:
            text_features = np.zeros((len(cfg.data.class_names), 512), np.float32)
        return cls(cfg, data, text_features, device=device, **kw)
    return cls(cfg, data, device=device, **kw)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("-c", "--cfg", default="nuscenes-unet-uncond")
    parser.add_argument("-b", "--batch-size", type=int, default=None, help="the global batch (all ranks)")
    parser.add_argument("--num-steps", type=int, default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="override a config field with a JSON value, e.g. data.data_root='\"data/nuscenes\"'")
    parser.add_argument("--synthetic-data", action="store_true",
                        help="train on generated batches: random range images for the uncond and flow configs; "
                             "banded range images with a random layout batch for the layout-conditioned configs, "
                             "synthetic scene graphs for nuscenes-layout, synthetic box points for nuscenes-object "
                             "(the JAX CLI has no synthetic source for those)")
    parser.add_argument("--workers", type=int, default=2, help="loader threads for file data (0: synchronous)")
    parser.add_argument("--clip-ckpt", default=None,
                        help="OpenAI CLIP checkpoint whose text tower encodes the layout task's words")
    parser.add_argument("--clip-bpe", default=None, help="CLIP's BPE merges file (with --clip-ckpt)")
    parser.add_argument("--text-features", default=None,
                        help="CLIP class-text table pickle, (num_class, 512) (object branch; zeros without it)")
    parser.add_argument("--resume", nargs="?", const="auto", default=None,
                        help="resume from a checkpoint dir, or (no value) the newest ckpt_* in "
                             "--output-dir; restores weights, EMA, optimizer and step")
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="steps between checkpoints (default: the config's steps_save_model)")
    parser.add_argument("--log-dir", default=None, help="tracker output: events.jsonl and preview PNGs")
    parser.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of steps 4-6 here")
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic algorithms only (cuDNN, cuBLAS, scatter adds; an op without one "
                             "raises), so that a run repeats bit for bit")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=None, help="default: the config's training seed")
    parser.add_argument("--resolution", type=int, nargs=2, default=None,
                        help="override H W (smoke runs)")
    parser.add_argument("--model-channels", type=int, default=None,
                        help="override the UNets' channel width (smoke runs)")
    return parser


def config_from_args(args):
    """The config the parsed arguments describe: the registry's, reduced,
    overridden (``--set``), with the global batch."""
    cfg = apply_reduced_topology(get_config(args.cfg), resolution=args.resolution,
                                 model_channels=args.model_channels)
    for spec in args.set:
        apply_override(cfg, spec)
    if args.batch_size:
        cfg.training.batch_size_train = args.batch_size
    return cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = config_from_args(args)
    seed = cfg.training.seed if args.seed is None else args.seed
    parallel = DataParallel.from_env(args.device)
    device = args.device if parallel is None else parallel.device
    if args.synthetic_data and parallel is not None:
        raise SystemExit("data-parallel training reads files; --synthetic-data runs in one process")
    text = None
    if args.text_features:
        with open(args.text_features, "rb") as f:
            text = pickle.load(f)
    data = None
    if not args.synthetic_data:
        encode_fn = None
        if args.clip_ckpt:
            from .models.clip_text import load_clip_text_encoder

            encode_fn, _, _ = load_clip_text_encoder(args.clip_ckpt, args.clip_bpe, device)
        try:
            data = file_batches(cfg, seed, args.workers, parallel, encode_fn)
        except (FileNotFoundError, KeyError) as e:
            raise SystemExit(f"no training data for {args.cfg}: {e} (point --set data.data_root / data.pkl_path "
                             "at nuScenes-format files, or train with --synthetic-data)") from e
    tracker = None
    if args.log_dir and (parallel is None or parallel.is_main):
        tracker = JsonlTracker(args.log_dir)
    trainer = build_trainer(cfg, seed, device, text, data, output_dir=args.output_dir, tracker=tracker,
                            profile_dir=args.profile_dir, parallel=parallel)
    try:
        trainer.train(num_steps=args.num_steps, seed=seed, checkpoint_every=args.checkpoint_every,
                      log_every=args.log_every, resume=args.resume)
    finally:
        if tracker is not None:
            tracker.close()
        if parallel is not None:
            parallel.leave()


if __name__ == "__main__":
    main()
