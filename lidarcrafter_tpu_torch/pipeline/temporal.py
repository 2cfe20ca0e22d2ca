"""The 4D rollout: frame 0 from the layout-conditioned stack, then
autoregressive frames, each conditioned on the previous one.

Port of the JAX package's ``pipeline/temporal.py``.  Between frames the
previous frame's points are split into background and objects, the
background is warped by the ego motion and cleared where the next frame's
boxes stand, the objects are replayed at their next boxes, and the cloud is
projected into the next frame's conditions (``frame_conditions``).  All of
it runs batched over scenes on the frames' device with fixed shapes and no
host sync; frames leave the device only when ``rollout`` fetches them.

The trajectory and transform precompute is host numpy, as in the JAX
package; the geometry and the sampler stay float32, and only the denoiser
calls run in the engines' serving ``dtype``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..datasets import rollout as R
from ..diffusion.conditional import CondContinuousDiffusion
from ..ops.projection import convert_boxes_to_2d, norm3, points_to_range_image
from ..training.preprocess import (
    postprocess_sample,
    preprocess_autoregressive_cond,
    preprocess_condition_mask,
)
from ..utils.lidar import LiDARUtility


def image_points_carry(sample: torch.Tensor, lidar_utils: LiDARUtility):
    """Generated images (S, H, W, C) → padded clouds (S, H·W, 4) ``[xyz,
    reflectance·255]`` and masks (norm > 1e-2, ego radius |x|, |y| < 2
    dropped)."""
    post = postprocess_sample(sample, lidar_utils)
    S = sample.shape[0]
    xyz = post["xyz"].reshape(S, -1, 3)
    refl = post.get("reflectance")
    inten = refl.reshape(S, -1, 1) * 255.0 if refl is not None else xyz.new_zeros(S, xyz.shape[1], 1)
    pts = torch.cat([xyz, inten], dim=2)
    mask = norm3(xyz) > 1e-2
    mask &= ~((torch.abs(pts[..., 0]) < 2.0) & (torch.abs(pts[..., 1]) < 2.0))
    return pts, mask


def frame_conditions(
    pts: torch.Tensor,
    mask: torch.Tensor,
    boxes: torch.Tensor,
    next_boxes: torch.Tensor,
    transform: torch.Tensor,
    classes_col: torch.Tensor,
    box_mask: torch.Tensor,
    lidar_utils: LiDARUtility,
    *,
    num_classes: int = 8,
    max_points_per_obj: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's geometry step: the previous frame's clouds (S, N, 4) and
    masks, its boxes (S, K, 7), the next frame's boxes, the (S, 4, 4)
    inter-frame transforms and the (S, K, 1) class values → the next
    frame's ``concat_cond`` (S, H, W, num_classes+2) and
    ``autoregressive_cond`` (S, H, W, 1).

    The next frame's cloud is the refined background (H·W rows) followed by
    the K·P replayed object points."""
    H, W = lidar_utils.resolution
    depth_range = dict(min_depth=lidar_utils.min_depth, max_depth=lidar_utils.max_depth)
    S = pts.shape[0]
    bg_mask, obj_pts, obj_mask = R.split_foreground_background(
        pts, mask, boxes, box_mask, max_points_per_obj
    )
    bg_next = R.transform_points_homogeneous(pts, transform)
    next_boxes_cls = torch.cat([next_boxes, classes_col], dim=2)
    bg_next, bg_next_mask = R.refine_points_via_condition_mask(
        bg_next, bg_mask, next_boxes_cls, box_mask, H=H, W=W, **depth_range
    )
    fg_pts, fg_mask = R.replay_objects(obj_pts, obj_mask, next_boxes, box_mask)
    all_pts = torch.cat([bg_next, fg_pts.reshape(S, -1, 4)], dim=1)
    all_mask = torch.cat([bg_next_mask, fg_mask.reshape(S, -1)], dim=1)

    img = points_to_range_image(all_pts, all_mask, H=H, W=W, **depth_range)
    depth = img[..., 4:5] * img[..., 5:6]
    refl = img[..., 3:4] / 255.0 * img[..., 5:6]
    autoreg_cond = preprocess_autoregressive_cond(torch.cat([depth, refl], dim=-1), lidar_utils)
    _, condition_mask, _ = convert_boxes_to_2d(next_boxes_cls, box_mask, H=H, W=W)
    concat_cond = preprocess_condition_mask({"condition_mask": condition_mask}, lidar_utils, num_classes)
    return concat_cond, autoreg_cond


@dataclasses.dataclass
class SceneTracks:
    """Per-frame inputs of the autoregressive frames, on the device:
    ``boxes`` (S, T, K, 7) in the current frame (frame 0: ``boxes0``),
    ``next_boxes`` (S, T, K, 7) in the next frame, ``transforms``
    (S, T, 4, 4) float32, ``classes_col`` (S, K, 1), ``box_mask`` (S, K)."""

    boxes: torch.Tensor
    next_boxes: torch.Tensor
    transforms: torch.Tensor
    classes_col: torch.Tensor
    box_mask: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.boxes.shape[1]


def scene_tracks(
    gt_fut_trajs: np.ndarray,
    boxes0: np.ndarray,
    box_names_classes: np.ndarray,
    num_frames: int,
    interp_M: int | None,
    device: torch.device,
) -> SceneTracks:
    """Trajectories (host numpy) → the future boxes and the inter-frame ego
    transforms of ``min(num_frames, T)`` autoregressive frames.

    Per scene: ``gt_fut_trajs`` (K+1, 6, 2) per-agent future deltas (row 0
    the ego), ``boxes0`` (K, 7), ``box_names_classes`` (K,); a leading
    scene dim S batches all three, and single-scene inputs become S = 1."""
    gt_fut_trajs = np.asarray(gt_fut_trajs, np.float32)
    boxes0 = np.asarray(boxes0, np.float32)
    classes = np.asarray(box_names_classes, np.float32)
    if gt_fut_trajs.ndim == 3:
        gt_fut_trajs, boxes0, classes = gt_fut_trajs[None], boxes0[None], classes[None]
    S, K = boxes0.shape[:2]
    egos, objs = zip(*(R.expand_future_trajs(gt_fut_trajs[s], M=interp_M) for s in range(S)))
    transforms = np.stack([R.compute_inter_frame_transforms(e) for e in egos])  # (S, T, 4, 4)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    boxes0_t = dev(boxes0)
    fut = R.warp_boxes_future(boxes0_t, dev(np.stack(objs)), dev(np.stack(egos)))  # (S, K, T, 7)
    fut = fut.transpose(1, 2)  # (S, T, K, 7)
    T = min(num_frames, fut.shape[1])
    return SceneTracks(
        boxes=torch.cat([boxes0_t[:, None], fut[:, : T - 1]], dim=1)[:, :T],
        next_boxes=fut[:, :T],
        transforms=dev(transforms[:, :T]),
        classes_col=dev(classes)[..., None],
        box_mask=torch.ones((S, K), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass
class TemporalRollout:
    """Drives the layout-conditioned frame 0 and the autoregressive frames.

    ``cond_engine``: the layout-conditioned generator
    (``nuscenes-box-layout-*``); ``autoreg_engine``: the autoregressive one
    (``nuscenes-auto-reg-v2``); both built on ``device`` (``cuda`` unless the
    caller asks for the CPU; raises without a card)."""

    cond_engine: CondContinuousDiffusion
    autoreg_engine: CondContinuousDiffusion
    lidar_utils: LiDARUtility
    num_classes: int = 8
    max_points_per_obj: int = 512
    num_sampling_steps: int = 256
    sampling_mode: str = "ddpm"
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ----------------------------------------------------------- per-frame ops

    def generate_first_frame(self, batch: dict, generator=None, x_T=None) -> torch.Tensor:
        """Layout-conditioned frame 0 (S, H, W, C)."""
        return self.cond_engine.sample(
            batch, batch_size=batch["concat_cond"].shape[0], num_steps=self.num_sampling_steps,
            mode=self.sampling_mode, x_T=x_T, generator=generator,
        )

    def generate_next_frame(
        self, autoregressive_cond: torch.Tensor, layout_batch: dict, generator=None, x_T=None
    ) -> torch.Tensor:
        """One autoregressive frame from its condition and the layout batch."""
        batch = dict(layout_batch)
        batch["autoregressive_cond"] = autoregressive_cond
        return self.autoreg_engine.sample(
            batch, batch_size=autoregressive_cond.shape[0], num_steps=self.num_sampling_steps,
            mode=self.sampling_mode, x_T=x_T, generator=generator,
        )

    def image_to_points(self, sample: torch.Tensor):
        """Generated images (S, H, W, C) → padded (S, H·W, 4) clouds + masks."""
        return image_points_carry(sample, self.lidar_utils)

    def frame_conditions(self, pts, mask, tracks: SceneTracks, t: int):
        """Frame ``t``'s geometry step (see :func:`frame_conditions`)."""
        return frame_conditions(
            pts, mask, tracks.boxes[:, t], tracks.next_boxes[:, t], tracks.transforms[:, t],
            tracks.classes_col, tracks.box_mask, self.lidar_utils,
            num_classes=self.num_classes, max_points_per_obj=self.max_points_per_obj,
        )

    # --------------------------------------------------------------- rollout

    @torch.inference_mode()
    def rollout(
        self,
        first_frame_batch: dict,
        gt_fut_trajs: np.ndarray,
        boxes0: np.ndarray,
        box_names_classes: np.ndarray,
        generator: torch.Generator | None = None,
        num_frames: int = 15,
        interp_M: int | None = 16,
        fetch: bool = True,
        stream_chunks: int = 1,
        x_T: list | None = None,
    ) -> list:
        """The whole sequence, batched over scenes: frame 0, then up to
        ``num_frames`` autoregressive frames (see :func:`scene_tracks` for
        the scene inputs; ``first_frame_batch``'s values carry the same S).

        ``generator`` draws every frame's starting noise in turn; ``x_T``,
        a list of (S, H, W, C) tensors with frame 0 first, replaces those
        draws.  The first frame's batch stays the layout condition of every
        autoregressive frame, with ``concat_cond`` replaced and
        ``autoregressive_cond`` added.

        Returns the frames (S, H, W, C): host numpy with ``fetch``, else
        tensors on the device.  ``stream_chunks`` > 1 splits the frames into
        that many chunks and, on the card with ``fetch``, copies each
        chunk's frames to the host on a side stream while the next chunk
        computes; any value gives the same frames.
        """
        dev = self.device
        tracks = scene_tracks(gt_fut_trajs, boxes0, box_names_classes, num_frames, interp_M, dev)
        T = tracks.num_frames
        if x_T is not None and len(x_T) < T + 1:
            raise ValueError(f"x_T holds {len(x_T)} frames; the rollout needs {T + 1}")
        starts = list(x_T) if x_T is not None else [None] * (T + 1)
        batch0 = {k: torch.as_tensor(v, device=dev) for k, v in first_frame_batch.items()}

        frames = [self.generate_first_frame(batch0, generator, starts[0])]
        carry = self.image_to_points(frames[0])
        copier = _HostCopier(dev) if fetch else None
        chunks = max(1, min(int(stream_chunks), T))
        bounds = np.linspace(0, T, chunks + 1).astype(int)
        for c in range(chunks):
            for t in range(bounds[c], bounds[c + 1]):
                concat_cond, autoreg_cond = self.frame_conditions(*carry, tracks, t)
                batch = dict(batch0, concat_cond=concat_cond)
                frames.append(self.generate_next_frame(autoreg_cond, batch, generator, starts[t + 1]))
                carry = self.image_to_points(frames[-1])
            if copier is not None:  # this chunk's frames (frame 0 with the first)
                copier.start(frames[len(copier) :])
        if copier is None:
            return frames
        copier.start(frames[len(copier) :])  # T == 0: frame 0 alone
        return copier.finish()


class _HostCopier:
    """Copies frames to the host.  On the card each copy goes on a side
    stream into pinned memory, after the work queued so far, so that it
    overlaps what is queued next; ``finish`` waits for all of them."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.host: list[torch.Tensor] = []

    def __len__(self) -> int:
        return len(self.host)

    def start(self, frames: list) -> None:
        if self.stream is None:
            self.host.extend(frames)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            for f in frames:
                dst = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                dst.copy_(f, non_blocking=True)
                f.record_stream(self.stream)
                self.host.append(dst)

    def finish(self) -> list[np.ndarray]:
        if self.stream is not None:
            self.stream.synchronize()
        return [h.numpy() for h in self.host]
