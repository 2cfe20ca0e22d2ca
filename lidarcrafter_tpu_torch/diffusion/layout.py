"""Layout (1D) diffusion: per-node box + trajectory vectors conditioned on
a scene graph.

Port of the JAX package's ``diffusion/layout.py::CondLayoutDiffusion``.  x
is the flat node batch (N, 20): 8 box and 12 trajectory columns; the loss
mask is the validity block ``boxes[:, 20:]``.  All nodes of a scene share
one t, drawn per scene and gathered to the nodes by ``scene_ids``.  The
condition model is ``SceneGraph``; the denoiser (``UNet1DModel``) receives
``{'preds', 'uc_b', 'c_b', 'edge_mask'}``.

Sampling runs the scene-graph encoder once per request, then DDPM or DDIM
on the uniform t grid (the JAX sampler offers no other).  Draws come from
one ``torch.Generator`` in the JAX sampler's order: x_T, the encoder's
change noise, then each step's noise.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from .conditional import CondContinuousDiffusion


@dataclasses.dataclass(kw_only=True)
class CondLayoutDiffusion(CondContinuousDiffusion):
    """``model(x_t (N, C), {'time_condition', 'other_condition'})``;
    ``cond_model(objs, triples, text_feats, rel_feats, ...)`` returns
    (latent, obj_embed)."""

    def get_network_condition(self, input_dict: dict, generator: torch.Generator | None = None) -> dict:
        """``other_condition`` from the scene graph ``input_dict['scenegraph']``
        (``objs``, ``triples``, ``text_feats``, ``rel_feats`` and the optional
        ``added_mask``, ``manipulated_mask``, ``edge_mask``)."""
        sg = input_dict["scenegraph"]
        latent, obj_embed = self.cond_model(
            sg["objs"], sg["triples"], sg["text_feats"], sg["rel_feats"],
            added_mask=sg.get("added_mask"), manipulated_mask=sg.get("manipulated_mask"),
            edge_mask=sg.get("edge_mask"), generator=generator,
        )
        return dict(other_condition=dict(
            preds=sg["triples"], uc_b=obj_embed, c_b=latent, edge_mask=sg.get("edge_mask")))

    def sample_timesteps(self, scene_ids: torch.Tensor, num_scenes: int,
                         generator: torch.Generator | None = None) -> torch.Tensor:
        """One uniform t per scene, gathered to the nodes."""
        t_scene = torch.rand((num_scenes,), generator=generator, device=scene_ids.device, dtype=torch.float32)
        return t_scene[scene_ids]

    def p_loss(
        self,
        input_dict: dict,
        t: torch.Tensor,
        noise: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The loss of ``input_dict['x_0']`` (N, C) at the node timesteps ``t``
        (N,); the encoder's change noise, then the noise unless given, drawn
        from ``generator``."""
        condition = self.get_network_condition(input_dict, generator)
        return self.weighted_loss(input_dict["x_0"], t, noise, loss_mask, condition, generator)

    def loss(
        self,
        input_dict: dict,
        num_scenes: int,
        generator: torch.Generator | None = None,
        t_scene: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Training loss of ``input_dict['boxes']`` (N, 40): x_0 is its first
        20 columns, the mask the rest.  The per-scene timesteps ``t_scene``
        (num_scenes,), the encoder's change noise and the noise are drawn
        from ``generator`` in that order unless given."""
        boxes = input_dict["boxes"]
        x_0, loss_mask = boxes[:, :20], boxes[:, 20:]
        if loss_mask.shape[1] == 0:
            loss_mask = None
        elif loss_mask.shape[1] != x_0.shape[1]:
            loss_mask = loss_mask[:, :1].expand(x_0.shape)
        scene_ids = input_dict["scene_ids"]
        if t_scene is None:
            t = self.sample_timesteps(scene_ids, num_scenes, generator)
        else:
            t = t_scene[scene_ids]
        return self.p_loss(dict(input_dict, x_0=x_0), t, noise, loss_mask, generator)

    def p_step_cond(
        self,
        x_t: torch.Tensor,
        condition: dict,
        t: torch.Tensor,
        s: torch.Tensor,
        mode: Literal["ddpm", "ddim"] = "ddpm",
        ddim_eta: float = 0.0,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One reverse step p(z_s | z_t), DDPM or DDIM, on ``condition``
        (``get_network_condition``'s output)."""
        if mode not in ("ddpm", "ddim"):
            raise ValueError(f"the layout sampler steps with ddpm or ddim, not {mode!r}")
        return self.p_step(x_t, t, s, mode, ddim_eta, generator, condition, noise=noise)

    @torch.inference_mode()
    def sample(
        self,
        input_dict: dict,
        num_steps: int,
        mode: Literal["ddpm", "ddim"] = "ddpm",
        ddim_eta: float = 0.0,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The flat node batch (N, C) of ``input_dict`` (``boxes`` (N, ·),
        ``scenegraph``) sampled from ``x_T`` (drawn from ``generator`` when
        not given) conditioned on its scene graph."""
        if mode not in ("ddpm", "ddim"):
            raise ValueError(f"the layout sampler steps with ddpm or ddim, not {mode!r}")
        x = self.start(input_dict["boxes"].shape[0], x_T, generator)
        condition = self.get_network_condition(input_dict, generator)
        return self.reverse(x, num_steps, mode, ddim_eta, generator, condition)
