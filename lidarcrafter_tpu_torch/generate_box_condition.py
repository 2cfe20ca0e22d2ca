"""Per-scene box-condition range features (data pipeline step 5).

Port of the JAX package's ``tools/generate_box_condition.py``: sample each
scene's object clouds from the object diffusion model (``ObjectGenerator``,
DDPM, ``--num-steps``), place them at their boxes
(``datasets/transforms.py::unnorm_fg_points``) with a class channel, project
them to a range image (``ops/projection.py::points_to_range_image``) and
save the normalised (C, H, W) condition of each scene as
``<output-dir>/<split>/sample_{idx:07d}.npy``.  ``--synthetic-scenes N``
draws N scenes of fabricated boxes and ``--random-params`` skips the
checkpoint: a run with no data.  Scene ``idx`` draws from
``torch.Generator(device)`` seeded with ``idx``.  No kernel of the port is
on this path (``PointUNet`` is Linears and pointwise ops); it runs on the
card unless ``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.generate_box_condition --ckpt runs/object/ckpt_... \\
      [--split train] [--num-steps 1024] [-o data/box_condition]
  python -m lidarcrafter_tpu_torch.generate_box_condition --random-params --synthetic-scenes 2 -o /tmp/box_cond
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np
import torch

from .configs import get_config
from .datasets import make_dataset
from .datasets import transforms as T
from .generate_object import ObjectGenerator
from .ops.projection import points_to_range_image
from .utils.lidar import LiDARUtility


def synthetic_scene(rng: np.random.RandomState, num_boxes: int = 3) -> np.ndarray:
    """Fabricated scene boxes (x y z l w h yaw cls), class 1-based (0 is
    the ego), as the JAX tool draws them."""
    boxes = np.zeros((num_boxes, 8), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (num_boxes, 2))
    boxes[:, 2] = rng.uniform(-1, 0.5, num_boxes)
    boxes[:, 3:6] = rng.uniform(1.5, 4.5, (num_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, num_boxes)
    boxes[:, 7] = rng.randint(1, 4, num_boxes)
    return boxes


def object_request(fg_boxes: np.ndarray, text: np.ndarray) -> dict:
    """The object branch's request for a scene's boxes."""
    enc = np.stack([T.encoding_boxes_3d(b[:7], unique_mode=True) for b in fg_boxes]).astype(np.float32)
    return {"fg_encoding_box": enc, "fg_class": fg_boxes[:, 7].astype(np.int64) - 1, "fg_text_features": text}


def make_condition(img: torch.Tensor, lidar_utils: LiDARUtility, train_depth: bool,
                   train_reflectance: bool) -> torch.Tensor:
    """(H, W, 7) [x y z i sem depth valid] → the (C, H, W) condition:
    the normalised depth and / or intensity of the valid pixels, then the
    class channel."""
    img = img * img[..., 6:7]
    x = []
    if train_depth:
        x.append(lidar_utils.convert_depth(img[..., 5:6]))
    if train_reflectance:
        x.append(img[..., 3:4] / 255.0)
    x = lidar_utils.normalize(torch.cat(x, dim=-1))
    return torch.cat([x, img[..., 4:5]], dim=-1).permute(2, 0, 1)


def scene_condition(clouds: np.ndarray, fg_boxes: np.ndarray, lidar_utils: LiDARUtility, obj_data, lidar_cfg,
                    device: str | torch.device = "cpu") -> np.ndarray:
    """The condition of one scene from its (B, N, 4) box-frame object
    clouds and (B, 8) boxes: each cloud placed at its box with its class
    as a fifth column, all projected together, then :func:`make_condition`."""
    placed = [np.hstack([T.unnorm_fg_points(clouds[i], fg_boxes[i][:7]),
                         np.full((clouds.shape[1], 1), fg_boxes[i][7], np.float32)]) for i in range(len(fg_boxes))]
    cloud = torch.as_tensor(np.concatenate(placed, axis=0).astype(np.float32), device=device)
    H, W = lidar_cfg.resolution
    img = points_to_range_image(cloud, H=H, W=W, min_depth=lidar_cfg.min_depth, max_depth=lidar_cfg.max_depth,
                                fov_up=lidar_cfg.fov_up, fov_down=lidar_cfg.fov_down)
    return make_condition(img, lidar_utils, obj_data.train_depth, obj_data.train_reflectance).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg", default="nuscenes-object")
    p.add_argument("--layout-cfg", default="nuscenes-box-layout")
    p.add_argument("--ckpt", default=None, help="object training checkpoint dir (its EMA weights)")
    p.add_argument("--random-params", action="store_true", help="skip the checkpoint (smoke runs)")
    p.add_argument("--split", default="train")
    p.add_argument("--num-steps", type=int, default=1024)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--synthetic-scenes", type=int, default=0)
    p.add_argument("--text-features", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("-o", "--output-dir", default="data/box_condition")
    args = p.parse_args(argv)
    if not (args.ckpt or args.random_params):
        raise SystemExit("pass --ckpt or --random-params")

    cfg = get_config(args.cfg)
    layout_cfg = get_config(args.layout_cfg)
    lidar_cfg = layout_cfg.data
    gen = ObjectGenerator(cfg, device=args.device, ckpt=None if args.random_params else args.ckpt)
    lidar_utils = LiDARUtility.create(tuple(lidar_cfg.resolution), lidar_cfg.depth_format, lidar_cfg.min_depth,
                                      lidar_cfg.max_depth, fov_up=lidar_cfg.fov_up, fov_down=lidar_cfg.fov_down,
                                      device=gen.device)
    if args.text_features:
        with open(args.text_features, "rb") as f:
            text = np.asarray(pickle.load(f), np.float32)
    else:
        text = np.zeros((len(cfg.data.class_names), 512), np.float32)

    if args.synthetic_scenes:
        rng = np.random.RandomState(0)
        scenes = [synthetic_scene(rng) for _ in range(args.synthetic_scenes)]
    else:
        lidar_cfg.split = args.split
        lidar_cfg.task = "layout_generation"
        ds = make_dataset(layout_cfg)
        n = len(ds) if args.limit is None else min(args.limit, len(ds))
        scenes = [ds[i]["gt_boxes"][1:] for i in range(n)]

    out = Path(args.output_dir) / args.split
    out.mkdir(parents=True, exist_ok=True)
    for idx, fg_boxes in enumerate(scenes):
        if len(fg_boxes) == 0:
            continue
        clouds = gen.generate(object_request(fg_boxes, text), args.num_steps, mode="ddpm", seed=idx)
        cond = scene_condition(clouds.cpu().numpy(), fg_boxes, lidar_utils, cfg.data, lidar_cfg, gen.device)
        np.save(out / f"sample_{idx:07d}.npy", cond)
        print(f"[{idx + 1}/{len(scenes)}] saved {cond.shape}")
    print("done")


if __name__ == "__main__":
    main()
