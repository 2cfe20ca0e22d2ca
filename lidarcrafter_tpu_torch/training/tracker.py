"""Training observability: scalar trackers and sample-image rendering.

Port of the JAX package's ``training/tracker.py``:

- :class:`JsonlTracker`: scalars to ``events.jsonl``, images to
  ``images/<step:010d>/<tag>.png``, written with the standard library
  (``zlib`` + ``struct``), so it needs no imaging package;
- :class:`TensorBoardTracker`: ``torch.utils.tensorboard`` events, imported
  when one is made (it needs the ``tensorboard`` package);
- :func:`render_sample_images`: depth / metric depth / mask / reflectance
  colorizations and the surface-normal BEV splat of a sample batch,
  rendered on the sample's device and returned as host uint8 arrays.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..utils import render


def write_png(path, img: np.ndarray) -> None:
    """An (H, W, 3) or (H, W) uint8 image as an 8-bit RGB / grey PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 on every row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """The pixels of a PNG that :func:`write_png` wrote (8-bit RGB or grey,
    filter 0 on every row), as uint8; checks every chunk's CRC."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    if depth != 8 or color not in (0, 2):
        raise ValueError(f"{path}: only 8-bit RGB or grey")
    ch = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter 0")
    img = rows[:, 1:].reshape(h, w, ch)
    return img if ch == 3 else img[..., 0]


class JsonlTracker:
    """Scalars → ``<log_dir>/events.jsonl``; images → ``<log_dir>/images/``."""

    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.log_dir / "events.jsonl", "a")

    def log(self, scalars: dict, step: int) -> None:
        rec = {"step": int(step), "wall_time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_images(self, images: dict, step: int) -> None:
        out = self.log_dir / "images" / f"{int(step):010d}"
        out.mkdir(parents=True, exist_ok=True)
        for tag, img in images.items():
            img = np.asarray(img)
            if img.ndim == 4:  # (B, H, W, 3) → a vertical strip
                img = img.reshape(-1, *img.shape[2:])
            if img.dtype != np.uint8:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            write_png(out / (tag.replace("/", "_") + ".png"), img)

    def close(self) -> None:
        self._fh.close()


class TensorBoardTracker:
    """``torch.utils.tensorboard`` writer."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("TensorBoardTracker needs the tensorboard package; use JsonlTracker without it") from e
        self.writer = SummaryWriter(log_dir)

    def log(self, scalars: dict, step: int) -> None:
        for k, v in scalars.items():
            self.writer.add_scalar(k, float(v), int(step))

    def log_images(self, images: dict, step: int) -> None:
        for tag, img in images.items():
            img = np.asarray(img)
            if img.ndim == 3:
                img = img[None]
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            self.writer.add_images(tag, img, int(step), dataformats="NHWC")

    def close(self) -> None:
        self.writer.close()


def make_tracker(kind: str | None, log_dir: str):
    if kind in (None, "none"):
        return None
    if kind == "jsonl":
        return JsonlTracker(log_dir)
    if kind == "tensorboard":
        return TensorBoardTracker(log_dir)
    raise ValueError(f"unknown tracker kind: {kind!r}")


@torch.no_grad()
def render_sample_images(sample: torch.Tensor, lidar_utils, train_depth: bool = True,
                         train_reflectance: bool = True, tag: str = "sample", bev_size: int = 512) -> dict:
    """(B, H, W, C) normalized [-1, 1] samples → tag → uint8 RGB (numpy)."""
    sample = sample.float()
    img = lidar_utils.denormalize(torch.clamp(sample, -1, 1))
    out: dict = {}
    ch = 0
    if train_depth:
        depth = img[..., ch: ch + 1]
        ch += 1
        metric = lidar_utils.revert_depth(depth)
        mask = ((metric > lidar_utils.min_depth) & (metric < lidar_utils.max_depth)).float()
        out[f"{tag}/depth"] = render.colorize(depth)
        out[f"{tag}/depth_orig"] = render.colorize(metric / lidar_utils.max_depth)
        out[f"{tag}/mask"] = render.colorize(mask)
        xyz = lidar_utils.to_xyz(metric) / lidar_utils.max_depth * mask
        normal = lidar_utils.denormalize(-render.estimate_surface_normal(xyz))
        B = xyz.shape[0]
        bev = render.render_point_clouds(points=xyz.reshape(B, -1, 3), colors=normal.reshape(B, -1, 3),
                                         size=bev_size, t=xyz.new_tensor([0.0, 0.0, 1.0]))
        out[f"{tag}/bev"] = torch.clamp(bev, 0.0, 1.0)
    if train_reflectance:
        out[f"{tag}/reflectance"] = render.colorize(img[..., ch: ch + 1])
    return {k: np.clip(v.cpu().numpy() * 255.0, 0, 255).astype(np.uint8) for k, v in out.items()}
