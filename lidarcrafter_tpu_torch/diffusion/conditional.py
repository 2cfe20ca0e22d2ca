"""Conditional continuous-time diffusion: the training loss and the
sampler.

Port of the JAX package's ``diffusion/conditional.py``
(``CondContinuousDiffusion``) for the layout stacks, whose encoder output is
a dict that the layout UNet reads itself (``cond_mode='concat'``:
``LayoutUnetV1`` concatenates its ``concat_cond``; ``cond_mode=None``: the
v0 ``LayoutUnet`` takes none), for a condition encoder that returns a map,
which ``cond_mode='concat'`` concatenates onto the noisy input, and for the
object branch (``ObjectGenEncoder`` feeding
``PointUNet`` its (B, 768) condition, over (B, 1024, 4) clouds).  ``p_loss`` / ``loss`` run the condition encoder under autograd, so
its parameters train with the denoiser's, and ``w_loss_weight`` takes the
``scene_loss_weight_map`` as the loss mask.  For sampling the encoder runs
once per ``sample`` call, then the shared reverse loop of ``continuous.py``
takes x_T to x_0 with DDPM, DDIM or DPM-Solver++(2M); ``inpaint`` is the
conditioned RePaint over the shared loop.  Only the denoiser call differs
from the unconditional engine: the model takes a condition dict.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import torch
from torch import nn

from ..draws import Rows
from ..parallel.mesh import Mesh
from ..precision import cast_tree
from .continuous import ContinuousDiffusion

# the keys of an engine input dict that hold range-image maps (B, H, W[, C]):
# under the azimuth axis a rank holds its columns of them
AZIMUTH_KEYS = ("x_0", "concat_cond", "autoregressive_cond", "scene_loss_weight_map")


@dataclasses.dataclass(kw_only=True)
class CondContinuousDiffusion(ContinuousDiffusion):
    """``model(x_t, {'time_condition', 'other_condition'})`` predicts eps /
    v / x_0; ``cond_model(batch_dict)`` returns ``other_condition``."""

    cond_model: nn.Module
    cond_mode: Literal["concat", None] = None
    w_loss_weight: bool = False

    def get_network_condition(self, batch_dict: dict) -> dict:
        return dict(other_condition=self.cond_model(batch_dict))

    def denoise(self, x_t: torch.Tensor, log_snr_t: torch.Tensor, condition=None) -> torch.Tensor:
        """Image, time and the condition tree go in as ``dtype``; the
        prediction comes back float32.  With ``cond_mode='concat'`` and an
        encoder that returns a tensor, that map is concatenated onto the
        noisy input and the model sees the time alone."""
        cd = cast_tree(dict(condition), self.dtype)
        cd["time_condition"] = log_snr_t.to(self.dtype)
        x = x_t.to(self.dtype)
        if self.cond_mode == "concat" and isinstance(cd.get("other_condition"), torch.Tensor):
            x = torch.cat([x, cd.pop("other_condition")], dim=-1)
        return self.model(x, cd).float()

    def p_loss(
        self,
        input_dict: dict,
        t: torch.Tensor,
        noise: torch.Tensor | None = None,
        loss_mask: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The loss of ``input_dict['x_0']`` at timesteps ``t`` (B,), the
        encoder run on ``input_dict``; the noise is drawn from ``generator``
        unless given."""
        condition = self.get_network_condition(input_dict)
        return self.weighted_loss(input_dict["x_0"], t, noise, loss_mask, condition, generator)

    def loss(
        self,
        input_dict: dict,
        generator: torch.Generator | None = None,
        loss_mask: torch.Tensor | None = None,
        t: torch.Tensor | None = None,
        noise: torch.Tensor | None = None,
        rows: Rows | None = None,
    ) -> torch.Tensor:
        """Training loss with uniform continuous timesteps (``t``, then the
        noise, drawn from ``generator`` unless given, :meth:`draw`); with
        ``w_loss_weight`` the (B, H, W) ``scene_loss_weight_map``, when the
        batch has one, is the loss mask."""
        x_0 = input_dict["x_0"]
        t, noise = self.draw(x_0, generator, rows, t, noise)
        if self.w_loss_weight and loss_mask is None:
            w = input_dict.get("scene_loss_weight_map")
            if w is not None:
                loss_mask = w[..., None].expand(x_0.shape)
        return self.p_loss(input_dict, t, noise, loss_mask, generator)

    @torch.inference_mode()
    def sample(
        self,
        batch_dict: dict,
        batch_size: int,
        num_steps: int,
        mode: Literal["ddpm", "ddim", "dpmpp_2m"] = "ddpm",
        ddim_eta: float = 0.0,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        mesh: Mesh | None = None,
    ) -> torch.Tensor:
        """Conditioned sampling from ``x_T`` (drawn from ``generator`` when
        not given); returns x_0 (B, *sampling_shape): (B, H, W, C) frames,
        or (B, num_points, point_dim) object clouds.  On a ``mesh`` (range
        images) ``batch_dict`` holds this rank's share of the batch (rows
        over ``dp``; the image maps, ``concat_cond`` and
        ``autoregressive_cond``, cut to its columns), each rank denoises its
        share (:meth:`reverse_on_mesh`) and every rank returns the whole
        x_0."""
        x = self.start(batch_size, x_T, generator)
        if mesh is not None:
            with mesh.active():
                condition = self.get_network_condition(batch_dict)
            return self.reverse_on_mesh(mesh, x, num_steps, mode, ddim_eta, generator, condition)
        condition = self.get_network_condition(batch_dict)
        return self.reverse(x, num_steps, mode, ddim_eta, generator, condition)

    @torch.inference_mode()
    def inpaint(
        self,
        known: torch.Tensor,
        mask: torch.Tensor,
        batch_dict: dict,
        num_steps: int,
        num_resample_steps: int = 1,
        jump_length: int = 1,
        x_T: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        draw: Callable[[str, int, int], torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """Conditioned RePaint: the encoder runs once on ``batch_dict``, then
        :meth:`ContinuousDiffusion.repaint_loop` fills ``known`` where
        ``mask`` is 0."""
        x = self.start(known.shape[0], x_T, generator)
        condition = self.get_network_condition(batch_dict)
        return self.repaint_loop(x, known, mask, num_steps, num_resample_steps, jump_length,
                                 generator, draw, condition)
