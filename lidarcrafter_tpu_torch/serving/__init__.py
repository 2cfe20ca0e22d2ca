"""Ahead-of-time serving: a whole sampler exported with ``torch.export``."""

from .export import build_sampler_program, export_sampler, load_artifact, save_artifact

__all__ = ["build_sampler_program", "export_sampler", "load_artifact", "save_artifact"]
