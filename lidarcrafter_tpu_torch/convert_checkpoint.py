"""Convert a released upstream ``.pth`` checkpoint into a port checkpoint
that every generator's ``--ckpt`` reads: the port's counterpart of the JAX
package's ``tools/convert_checkpoint.py``.

Covers every architecture pair of the config registry that the JAX route
ingests: ``EfficientUNet`` (uncond, kitti-360) and its MeanFlow variant,
HDiT, ``LayoutUnetV1`` / v0 ``LayoutUnet`` with ``LayoutTransformerEncoder``
(box-layout v0–v4, v6, auto-reg), ``UNet1DModel`` + ``SceneGraph`` (layout)
and ``PointUNet`` + ``ObjectGenEncoder`` (object); ``nuscenes-box-layout-v5``
is refused, as the JAX converters cannot ingest it.  The EMA weights are
read when the checkpoint has them (``--no-ema``: the online ones), as the
reference's ``inference.py`` loads them.  The checkpoint written
(``training/checkpoint.py``) holds the converted weights as both its online
and its EMA weights, so ``generate``, ``generate_cond``,
``generate_layout``, ``generate_object`` (EMA), ``generate_flow`` and
``sample_temporal`` (online or EMA) all serve them.  Validation loads them
strictly into the config's freshly built modules (``--no-validate`` skips
it).  The conversion runs on the CPU.

Usage::

  python -m lidarcrafter_tpu_torch.convert_checkpoint \\
      --torch-ckpt nusc-unet-uncond-300000.pth -c nuscenes-unet-uncond -o ckpts/uncond
  python -m lidarcrafter_tpu_torch.generate -c nuscenes-unet-uncond --ckpt ckpts/uncond

``--set path=json`` overrides config fields first (``--set
model.params.base_channels=16``), for checkpoints trained off the registry.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from .configs import apply_override, get_config
from .training.checkpoint import save_checkpoint
from .training.optim import make_optimizer
from .training.state import TrainState, module_params
from .utils.torch_ckpt import build_modules, ingest_engine_state_dict, load_torch_checkpoint


def convert_checkpoint(torch_ckpt, cfg, output, use_ema: bool = True, validate: bool = True) -> dict:
    """Convert ``torch_ckpt`` for ``cfg`` and write the port checkpoint
    ``output``; returns what was done (the upstream keys skipped, seconds
    in all and by step)."""
    t0 = time.perf_counter()
    skipped: list[str] = []
    sd, _ = load_torch_checkpoint(torch_ckpt, use_ema)
    t1 = time.perf_counter()
    # built without drawing weights: every tensor the checkpoint stores is filled below
    models = {k: m.to_empty(device="cpu") for k, m in build_modules(cfg, "meta").items()}
    states = ingest_engine_state_dict(cfg, sd, modules=models, skipped=skipped)
    for k, module in models.items():
        module.load_state_dict(states[k], strict=validate)
    t2 = time.perf_counter()
    # the online and the EMA weights are the same tensors (saved once), as the
    # JAX CLI's TrainState.create copies its params into ema_params
    state = TrainState(step=0, models=models, ema=models, opt_state=make_optimizer().init(module_params(models)))
    save_checkpoint(Path(output).resolve(), state, cfg=cfg)
    t3 = time.perf_counter()
    return {"skipped": skipped, "seconds": t3 - t0, "load_seconds": t1 - t0, "convert_seconds": t2 - t1,
            "save_seconds": t3 - t2}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--torch-ckpt", required=True, help="upstream .pth (weights / ema_weights / cfg dict)")
    parser.add_argument("-c", "--cfg", required=True, help="registry config the checkpoint was trained with")
    parser.add_argument("-o", "--output", required=True, help="port checkpoint directory to write")
    parser.add_argument("--no-ema", action="store_true", help="read the online weights even where EMA weights exist")
    parser.add_argument("--set", action="append", default=[], metavar="K=V",
                        help="config override, e.g. model.params.base_channels=16")
    parser.add_argument("--no-validate", action="store_true",
                        help="load the weights into the config's modules without the strict check "
                             "(the ingestion still holds every name and shape to them)")
    args = parser.parse_args(argv)
    cfg = get_config(args.cfg)
    for spec in args.set:
        apply_override(cfg, spec)
    with torch.no_grad():  # not process-wide: an in-process caller keeps its grad mode
        done = convert_checkpoint(args.torch_ckpt, cfg, args.output, use_ema=not args.no_ema,
                                  validate=not args.no_validate)
    if not args.no_validate:
        print("strict load into the config's modules: OK")
    print(f"skipped {len(done['skipped'])} upstream keys that no converter reads"
          + (f": {done['skipped'][:8]}{' …' if len(done['skipped']) > 8 else ''}" if done["skipped"] else ""))
    print(f"seconds: read {done['load_seconds']:.2f}, convert {done['convert_seconds']:.2f}, "
          f"write {done['save_seconds']:.2f}")
    print(f"wrote port checkpoint -> {args.output} ({done['seconds']:.2f} s)")


if __name__ == "__main__":
    main()
