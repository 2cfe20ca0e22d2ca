"""Does the loader set the pace of training from files on the card?

Writes the synthetic nuScenes-format tree of
``lidarcrafter_tpu_torch/utils/synthetic.py::write_nuscenes_tree``
(35,000-point clouds, 2 scenes x 4 frames a split), then

(1) times the loader alone (``train.file_batches``) at 0, 2 and 4 threads
    over ``--batches`` batches, after the first ``next()`` and the batches
    it queued (``queue_depth``) are drained;
(2) times a fixed pure-Python loop on the main thread alone and while the
    loader runs flat out at 2 and 4 threads (a thread takes its batches as
    fast as they come): the main thread's slowdown is the share of the
    interpreter the loader's threads hold;
(3) trains ``nuscenes-auto-reg-v2`` at full width (32x1024, B=2, bf16
    AMP) in this process in five modes: ``synthetic`` (the CLI's
    ``--synthetic-data`` source: x_0 made on the card, no host work),
    ``files-w0`` / ``files-w2`` / ``files-w4`` (the loader at 0, 2 and 4
    threads), ``files-cached`` (the same file batches, loaded before the
    run and cycled: the host prepares them as from the loader, but nothing
    loads during the steps), ``cached+loader-w4``: the cached batches
    beside the loader at 4 threads, its batches taken and dropped as fast
    as they come (the loader's work without its data), and
    ``cached+loader-process-w4``: the same loader in a process of its own
    (the host's cores and memory shared, the interpreter not).  Each run takes ``--warm`` steps, then
    ``--steps`` timed steps (the card synchronised before and after; the
    loss is read only at the end); the modes run in ``--rounds`` rounds,
    each in the opposite order of the one before.  No profiler runs.

Prints a JSON line a measurement, each with the card's name and power
limit (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
The port's kernels build on first use; the script needs one card.

Usage: python -m lidarcrafter_tpu_torch.train_pace [--steps 50] [--warm 10] [--rounds 2] [--batches 40]
       [--modes MODE ...] [--skip-loader] [--switch-interval S]
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from . import train as train_cli
from .configs import get_config
from .utils.synthetic import point_config_at_tree, write_nuscenes_tree

CONFIG = "nuscenes-auto-reg-v2"
QUEUE_DEPTH = 4  # PrefetchLoader's default, which train.file_batches keeps
MODES = ("synthetic", "files-w0", "files-w2", "files-w4", "files-cached", "cached+loader-w4",
         "cached+loader-process-w4")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def loader_rate(cfg, workers: int, batches: int) -> float:
    """Batches a second of the loader alone, past its first queue."""
    stream = train_cli.file_batches(cfg, 0, workers)
    for _ in range(1 + QUEUE_DEPTH):  # the first batch, then the batches it queued
        next(stream)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(stream)
    rate = batches / (time.perf_counter() - t0)
    stream.close()
    return rate


def python_loop_s() -> float:
    """Seconds of a fixed pure-Python loop on this thread."""
    t0 = time.perf_counter()
    total = 0
    for i in range(3_000_000):
        total += i & 7
    return time.perf_counter() - t0


class Beside:
    """A thread that drains the loader at ``workers`` threads beside the
    caller until ``stop()``, which returns the batches it took."""

    def __init__(self, cfg, workers: int):
        self.stream = train_cli.file_batches(cfg, 0, workers)
        self.halt, self.taken = threading.Event(), 0
        self.thread = threading.Thread(target=self._drain)
        self.thread.start()

    def _drain(self):
        while not self.halt.is_set():
            next(self.stream)
            self.taken += 1

    def stop(self) -> int:
        self.halt.set()
        self.thread.join()
        self.stream.close()
        return self.taken


def drain_forever(tree: dict, workers: int) -> None:
    """The loader at ``workers`` threads on ``tree``, drained until killed
    (the body of a process beside the trainer)."""
    cfg = point_config_at_tree(get_config(CONFIG), tree)
    stream = train_cli.file_batches(cfg, 0, workers)
    while True:
        next(stream)


def loop_beside_loader(cfg, workers: int) -> tuple[float, int]:
    """``python_loop_s`` while the loader at ``workers`` threads runs flat
    out, and the batches it delivered meanwhile."""
    beside = Beside(cfg, workers)
    time.sleep(0.5)
    seconds = python_loop_s()
    return seconds, beside.stop()


def steps_per_s(cfg, mode: str, warm: int, steps: int, cached: list, tree: dict) -> float:
    """Steps a second of ``steps`` training steps after ``warm`` in ``mode``."""
    if mode == "synthetic":
        data = None
    elif mode.startswith("files-w"):
        data = train_cli.file_batches(cfg, 0, int(mode.rsplit("w", 1)[1]))
    else:
        data = itertools.cycle(cached)
    trainer = train_cli.build_trainer(cfg, 0, "cuda", data=data, log_fn=None)
    state = trainer.train(num_steps=warm, checkpoint_every=10**9, log_every=10**9)
    beside = Beside(cfg, 4) if mode == "cached+loader-w4" else None
    process = None
    if mode == "cached+loader-process-w4":
        process = multiprocessing.get_context("spawn").Process(target=drain_forever, args=(tree, 4), daemon=True)
        process.start()
        time.sleep(10)  # its imports and its first batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.train(num_steps=warm + steps, state=state, checkpoint_every=10**9, log_every=10**9)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    if beside is not None:
        beside.stop()
    if process is not None:
        process.terminate()
        process.join()
    if hasattr(data, "close"):
        data.close()
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return rate


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--warm", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--batches", type=int, default=40)
    parser.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    parser.add_argument("--skip-loader", action="store_true", help="train only: no loader or loop timings")
    parser.add_argument("--switch-interval", type=float, default=None,
                        help="the interpreter's thread switch interval, s (sys.setswitchinterval; default 0.005)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_pace: no CUDA device", file=sys.stderr)
        return 2
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_nuscenes_tree(Path(tmp) / "nusc", num_points=35000, seed=13)
        cfg = point_config_at_tree(get_config(CONFIG), tree)
        for workers in () if args.skip_loader else (0, 2, 4):
            print(json.dumps({"measure": "loader", "workers": workers, "batches": args.batches,
                              "batches_per_s": loader_rate(cfg, workers, args.batches), "card": smi}), flush=True)
        for workers in () if args.skip_loader else (2, 4):  # alone, beside, alone, ... three times
            alone, beside, taken = [python_loop_s()], [], []
            for _ in range(3):
                seconds, n = loop_beside_loader(cfg, workers)
                beside.append(seconds)
                taken.append(n)
                alone.append(python_loop_s())
            print(json.dumps({"measure": "python loop beside the loader", "workers": workers, "alone_s": alone,
                              "beside_s": beside, "slowdown": statistics.median(beside) / statistics.median(alone),
                              "batches_meanwhile": taken, "card": smi}), flush=True)
        stream = train_cli.file_batches(cfg, 0, 0)
        cached = [next(stream) for _ in range(args.warm + args.steps)]
        stream.close()
        order = list(args.modes)
        for r in range(args.rounds):
            for mode in order:
                rate = steps_per_s(cfg, mode, args.warm, args.steps, cached, tree)
                print(json.dumps({"measure": "train", "config": CONFIG, "batch": cfg.training.batch_size_train,
                                  "round": r, "mode": mode, "steps": args.steps, "steps_per_s": rate,
                                  "switch_interval_s": sys.getswitchinterval(), "card": smi}), flush=True)
            order.reverse()
    return 0


if __name__ == "__main__":
    sys.exit(main())
