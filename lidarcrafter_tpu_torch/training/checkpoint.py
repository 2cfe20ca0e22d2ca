"""Checkpoints in torch format.

The reference saves ``{cfg, weights, ema_weights, optimizer, lr_scheduler,
global_step}`` and rehydrates configs from the checkpoint; the JAX package
keeps the same contents in an orbax checkpoint, which cannot be read
without JAX.  The port writes its own: a directory ``ckpt_{step:010d}/``
with ``state.pt`` (the online and EMA ``state_dict`` of each module, the
optimizer state and the step) and ``config.json``.  A save goes to a
temporary directory that is renamed when complete.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import torch
from torch import nn

from .state import TrainState


def config_to_dict(cfg) -> dict:
    def conv(o):
        if dataclasses.is_dataclass(o):
            return {k: conv(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, (tuple, list)):
            return [conv(v) for v in o]
        if isinstance(o, dict):
            return {k: conv(v) for k, v in o.items()}
        return o

    return conv(cfg)


def save_checkpoint(path: str | Path, state: TrainState, cfg=None) -> None:
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(
        {
            "step": state.step,
            "models": {k: m.state_dict() for k, m in state.models.items()},
            "ema": {k: m.state_dict() for k, m in state.ema.items()},
            "opt_state": state.opt_state,
        },
        tmp / "state.pt",
    )
    if cfg is not None:
        with open(tmp / "config.json", "w") as f:
            json.dump(config_to_dict(cfg), f, indent=2, default=str)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _load(path: str | Path) -> dict:
    return torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)


def restore_checkpoint(path: str | Path, template: TrainState) -> tuple[TrainState, dict | None]:
    """Load the checkpoint at ``path`` into ``template`` (its modules and
    optimizer state are overwritten in place, on their devices); returns it
    and the saved config dict, if any."""
    saved = _load(path)
    for key, field in (("models", template.models), ("ema", template.ema)):
        for name, module in field.items():
            module.load_state_dict(saved[key][name])

    def to_template(value, like):
        if isinstance(like, torch.Tensor):
            return value.to(device=like.device, dtype=like.dtype)
        if isinstance(like, list):
            return [to_template(v, w) for v, w in zip(value, like, strict=True)]
        return value

    template.opt_state = {k: to_template(saved["opt_state"][k], v) for k, v in template.opt_state.items()}
    template.step = int(saved["step"])
    cfg_path = Path(path) / "config.json"
    cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else None
    return template, cfg


def load_weights(path: str | Path, models: dict[str, nn.Module], ema: bool = True) -> None:
    """Load the EMA (or, with ``ema=False``, the online) weights of the
    checkpoint at ``path`` into ``models`` ({'model'} or {'model', 'cond'}),
    running statistics included, as the serving CLIs sample with."""
    saved = _load(path)["ema" if ema else "models"]
    for name, module in models.items():
        module.load_state_dict(saved[name])


def latest_checkpoint(output_dir: str | Path) -> str | None:
    """Newest ``ckpt_*`` under ``output_dir`` (step-ordered), or None."""
    ckpts = sorted(p for p in Path(output_dir).glob("ckpt_*") if not p.name.endswith(".tmp"))
    return str(ckpts[-1]) if ckpts else None
