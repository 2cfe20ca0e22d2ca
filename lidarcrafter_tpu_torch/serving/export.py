"""Ahead-of-time sampler export for serving (``torch.export`` → ``.pt2``).

Port of the JAX package's ``serving/export.py``: the whole sampler, the
condition encoder, the N-step reverse loop (DDPM, DDIM at η = 0 or
DPM-Solver++(2M)) and ``postprocess_sample``, is traced once with the
weights in it and saved; a serving host loads the artifact and calls it
with seeds (and a per-request condition), with no model code, config or
checkpoint on the request path.

Artifacts are directories::

    <dir>/sampler.pt2   # torch.export.save of the ExportedProgram
    <dir>/meta.json     # config, batch, steps, mode, dtype, shapes, device, ...

An exported graph cannot draw from a ``torch.Generator``, so the program
takes its noise as inputs: ``x_T`` and, for DDPM, the stack of per-step
draws.  :func:`load_artifact` returns ``fn(seed[, condition])``, which draws
them from ``torch.Generator(device).manual_seed(seed)`` on the device it
runs on, in the order the eager sampler draws them, so the artifact's frames
are the eager generator's frames for the same seed.  The reverse loop's
grid and coefficients are host floats, computed before tracing
(``ContinuousDiffusion.reverse_plan``) and unrolled into the graph.

The three Hopper kernels are operators (``torch.ops.lidarcrafter_torch.*``,
``kernels/``), so the graph records them wherever it is traced: an artifact
traced on CPU tensors runs the plain versions on the CPU and, moved to the
card (``load_artifact``'s default device), launches the kernels, as the
JAX package's artifact built on a TPU host embeds its Mosaic kernels.
Loading imports only those operator registrations.
"""

from __future__ import annotations

import json
import pathlib
from typing import Callable

import torch
from torch import nn

from ..precision import cast_tree

ARTIFACT_NAME = "sampler.pt2"
META_NAME = "meta.json"


class SamplerProgram(nn.Module):
    """One sampling request as a module: ``forward(x_T, noise=None,
    condition=None)`` runs the encoder on ``condition`` (conditional
    engines), the reverse loop from ``x_T`` with the per-step ``noise``
    (DDPM) and the postprocess; returns ``postprocess_sample``'s dict, or
    the raw [-1, 1] sample without ``with_postprocess``."""

    def __init__(self, engine, lidar_utils, *, num_steps: int, mode: str, with_postprocess: bool = True):
        super().__init__()
        self.engine = engine
        self.model = engine.model  # registered, so the program holds the weights
        self.cond_model = getattr(engine, "cond_model", None)
        self.lidar_utils = lidar_utils
        self.plan = engine.reverse_plan(num_steps, mode)
        self.with_postprocess = with_postprocess

    def forward(self, x_T: torch.Tensor, noise: torch.Tensor | None = None, condition: dict | None = None):
        from ..training.preprocess import postprocess_sample

        engine = self.engine
        cond = None if condition is None else engine.get_network_condition(condition)
        x = engine.reverse(x_T, self.plan.num_steps, self.plan.mode, condition=cond, plan=self.plan, noise=noise)
        return postprocess_sample(x, self.lidar_utils) if self.with_postprocess else x


def build_sampler_program(engine, lidar_utils, *, num_steps: int, mode: str = "ddim",
                          with_postprocess: bool = True) -> SamplerProgram:
    """The serving-shaped sampler of a built engine (its ``dtype`` and
    weights as the caller set them, e.g. ``CondFrameGenerator.engine``),
    in ``eval()`` mode."""
    if mode not in ("ddpm", "ddim", "dpmpp_2m"):
        raise ValueError(f"mode must be ddpm, ddim or dpmpp_2m, got {mode!r}")
    program = SamplerProgram(engine, lidar_utils, num_steps=num_steps, mode=mode,
                             with_postprocess=with_postprocess).eval()
    return program


def draw_inputs(sampling_shape, batch_size: int, num_steps: int, mode: str, seed: int,
                device: str | torch.device = "cpu") -> dict:
    """The program's noise inputs for ``seed``: ``x_T`` and, for DDPM, the
    (num_steps, B, ...) stack of per-step draws, drawn one tensor at a time
    from ``torch.Generator(device).manual_seed(seed)`` in the eager
    sampler's order (``start``, then each ``p_step``)."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch_size, *sampling_shape)
    out = {"x_T": torch.randn(shape, generator=g, device=device, dtype=torch.float32)}
    if mode == "ddpm":
        out["noise"] = torch.stack([torch.randn(shape, generator=g, device=device, dtype=torch.float32)
                                    for _ in range(num_steps)])
    return out


def export_sampler(
    engine,
    lidar_utils,
    *,
    batch_size: int,
    num_steps: int,
    mode: str = "ddim",
    with_postprocess: bool = True,
    condition_example: dict | None = None,
) -> torch.export.ExportedProgram:
    """Trace the sampler of ``engine`` into an ``ExportedProgram`` on the
    device its weights lie on, with grad off (so the kernels' wrappers
    record their operators), the weights' ``requires_grad`` restored after.
    A conditional engine needs ``condition_example``, the per-request
    condition dict (its shapes and dtypes are recorded, not its values)."""
    conditional = getattr(engine, "cond_model", None) is not None
    if conditional and condition_example is None:
        raise ValueError("conditional engine: pass condition_example with the per-request condition shapes")
    program = build_sampler_program(engine, lidar_utils, num_steps=num_steps, mode=mode,
                                    with_postprocess=with_postprocess)
    device = next(program.model.parameters()).device
    kwargs = draw_inputs(engine.sampling_shape, batch_size, num_steps, mode, 0, device)
    if conditional:
        kwargs["condition"] = cast_tree(condition_example, torch.float32)
    trained = [p for p in program.parameters() if p.requires_grad]
    try:
        for p in trained:
            p.requires_grad_(False)
        with torch.no_grad():
            return torch.export.export(program, (), kwargs)
    finally:
        for p in trained:
            p.requires_grad_(True)


def save_artifact(out_dir: str | pathlib.Path, exported: torch.export.ExportedProgram,
                  meta: dict) -> pathlib.Path:
    """Write ``exported`` and ``meta`` (at least ``batch_size``,
    ``num_steps``, ``mode``, ``sampling_shape``, ``conditional``) into an
    artifact directory."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out / ARTIFACT_NAME)
    device = next((t.device for t in exported.state_dict.values()), torch.device("cpu"))
    info = {"device": str(device), "torch_version": torch.__version__, **meta}
    (out / META_NAME).write_text(json.dumps(info, indent=2))
    return out


def load_artifact(art_dir: str | pathlib.Path, device: str | torch.device = "cuda"
                  ) -> tuple[Callable, dict]:
    """An artifact directory → ``(fn, meta)``: ``fn(seed)``, or
    ``fn(seed, condition)`` for a conditional artifact, draws the noise
    inputs for ``seed`` (:func:`draw_inputs`) and runs the program on
    ``device``: the card unless the caller asks for the CPU, whatever
    device the artifact was traced on (``meta["device"]``, kept for
    information); an artifact traced elsewhere is moved there."""
    from .. import resolve_device
    from ..kernels import attention, groupnorm, oaca  # noqa: F401  the operators the graph calls

    art = pathlib.Path(art_dir)
    meta = json.loads((art / META_NAME).read_text())
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    exported = torch.export.load(art / ARTIFACT_NAME)
    if torch.device(meta["device"]) != device:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    program = exported.module()
    shape, B, steps, mode = meta["sampling_shape"], meta["batch_size"], meta["num_steps"], meta["mode"]

    def fn(seed: int, condition: dict | None = None):
        inputs = draw_inputs(shape, B, steps, mode, seed, device)
        if meta["conditional"]:
            if condition is None:
                raise ValueError("a conditional artifact is called as fn(seed, condition)")
            inputs["condition"] = {k: v.to(device) for k, v in condition.items()}
        with torch.no_grad():
            return program(**inputs)

    return fn, meta
