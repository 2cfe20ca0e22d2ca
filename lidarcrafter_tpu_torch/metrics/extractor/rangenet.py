"""RangeNet-21 / 53 range-image backbone (the FRD and FRID extractor).

Port of the JAX package's ``metrics/extractor/rangenet.py``: a darknet
encoder whose ``down`` blocks halve only the width, and a transposed-conv
decoder with skip adds, on NCHW maps (the JAX package's are NHWC).
Inference only, on the BatchNorms' running statistics.  The FRD feature is
the decoder map flattened channel-major and sampled at 4,096 fixed
positions (upstream's ``random.seed(0)`` draw, reproduced exactly); the
FRID descriptor averages it over 16 row or column bands.

The submodules carry the flax names, so the JAX parameter tree loads
through ``weights.load_flax_params``.  :func:`convert_rangenet_state_dict`
reads upstream's torch ``RangeNet`` state_dict, and
:func:`convert_rangenet_folder` the pretrained folder's darknet-named
``backbone`` and ``segmentation_decoder``; :func:`to_rangenet_folder`
writes a model's weights back under the darknet names.
"""

from __future__ import annotations

import functools
import random
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .pointnet import FrozenBN

BACKBONES = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}  # residual blocks per encoder stage
NUM_FEATURES = 4096  # FRD features sampled from the decoder map


def _channels(i: int) -> int:
    return 32 << i


class ConvBNLReLU(nn.Module):
    """Conv (or ``ConvTranspose2d``) + frozen BN + LeakyReLU(0.1)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride, padding, transposed=False, use_bias=False):
        super().__init__()
        conv = nn.ConvTranspose2d if transposed else nn.Conv2d
        self.conv = conv(in_ch, out_ch, kernel_size, stride, padding, bias=use_bias)
        self.bn = FrozenBN(out_ch)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class ResidualBlock(nn.Module):
    """1x1 reduce + 3x3 expand, added to the input."""

    def __init__(self, mid_ch: int, out_ch: int):
        super().__init__()
        self.reduce = ConvBNLReLU(out_ch, mid_ch, 1, 1, 0)
        self.expand = ConvBNLReLU(mid_ch, out_ch, 3, 1, 1)

    def forward(self, x):
        return x + self.expand(self.reduce(x))


class RangeNetBlock(nn.Module):
    """One stage: a ``same`` / ``down`` (width / 2) / ``up`` (width x 2)
    conv, then ``num_blocks`` residual blocks."""

    def __init__(self, in_ch: int, out_ch: int, num_blocks: int, mode: str = "same"):
        super().__init__()
        if mode == "same":
            self.conv = ConvBNLReLU(in_ch, out_ch, 3, 1, 1)
        elif mode == "down":
            self.conv = ConvBNLReLU(in_ch, out_ch, 3, (1, 2), 1)
        elif mode == "up":
            self.conv = ConvBNLReLU(in_ch, out_ch, (1, 4), (1, 2), (0, 1), transposed=True, use_bias=True)
        else:
            raise ValueError(mode)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"res{i}", ResidualBlock(in_ch, out_ch))

    def forward(self, x):
        h = self.conv(x)
        for i in range(self.num_blocks):
            h = getattr(self, f"res{i}")(h)
        return h


class RangeNet(nn.Module):
    """RangeNet on (B, 5, H, W) [range, x, y, z, remission] inputs (W a
    multiple of 32).  ``forward(img, feature=None)``: ``'lidargen'`` → (B,
    4096) FRD features; ``'decoder'`` → the (B, 32, H, W) decoder map;
    None → class logits."""

    def __init__(self, num_classes: int = 20, in_ch: int = 5, backbone: int = 53):
        super().__init__()
        nrb = BACKBONES[backbone]
        self.stem = ConvBNLReLU(in_ch, 32, 3, 1, 1)
        for i in range(5):
            setattr(self, f"enc{i + 1}", RangeNetBlock(_channels(i), _channels(i + 1), nrb[i], "down"))
        for i in range(5, 0, -1):
            setattr(self, f"dec{i}", RangeNetBlock(_channels(i), _channels(i - 1), 1, "up"))
        self.head = nn.Conv2d(32, num_classes, 3, padding=1)

    def forward(self, img: torch.Tensor, feature: str | None = None) -> torch.Tensor:
        skips = [self.stem(img)]
        for i in range(1, 6):
            skips.append(getattr(self, f"enc{i}")(skips[-1]))
        h = skips.pop()
        for i in range(5, 0, -1):
            h = getattr(self, f"dec{i}")(h) + skips.pop()
        if feature == "lidargen":
            return flatten_and_subsample(h)
        if feature == "decoder":
            return h
        return self.head(h)


@functools.lru_cache(maxsize=8)
def _subsample_index(numel: int, device: torch.device) -> torch.Tensor:
    """Upstream's draw: ``random.seed(0)`` then ``random.sample`` of 4,096
    of ``numel`` positions (a private generator, same sequence); a normal
    tensor even when first drawn under ``inference_mode``, so that autograd
    may save it later."""
    with torch.inference_mode(False):
        return torch.tensor(random.Random(0).sample(range(numel), NUM_FEATURES), device=device)


def flatten_and_subsample(fmaps: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) decoder map → (B, 4096): flattened channel-major, as
    torch flattens, and sampled at the fixed positions."""
    flat = fmaps.reshape(fmaps.shape[0], -1)
    return flat[:, _subsample_index(flat.shape[1], flat.device)]


def preprocess_range_input(img: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Zero the empty pixels of (B, 5, H, W) [range, x, y, z, remission]
    (upstream's ``Preprocess``; its normalisation is off)."""
    if mask is None:
        mask = (img[:, 0:1] > 0).to(img.dtype)
    return img * mask


def rangenet_frid_descriptor(fmaps: torch.Tensor, agg_type: str = "depth", num_sectors: int = 16) -> torch.Tensor:
    """(B, C, H, W) decoder map → FRID descriptor: ``'depth'`` averages 16
    row bands, ``'sector'`` 16 column bands (each (B, C·16), channel-major),
    ``'all'`` the whole map (B, C)."""
    B, C, H, W = fmaps.shape
    N = num_sectors
    if agg_type == "all":
        return fmaps.mean(dim=(2, 3))
    if agg_type == "sector":
        x = fmaps.reshape(B, C, H, N, W // N).mean(dim=(2, 4))
    elif agg_type == "depth":
        x = fmaps.reshape(B, C, N, H // N, W).mean(dim=(3, 4))
    else:
        raise NotImplementedError(agg_type)
    return x.reshape(B, -1)


_BN_STATS = ("weight", "bias", "running_mean", "running_var")


def _cbl(out: dict, name: str, sd: Mapping, conv: str, bn: str, transposed: bool = False) -> None:
    """One ``ConvBNLReLU`` named ``name`` from upstream's conv ``conv`` and
    BatchNorm ``bn``; a plain conv has no bias in the model, so upstream's
    is dropped, as the JAX package's model ignores it."""
    out[f"{name}.conv.weight"] = sd[f"{conv}.weight"]
    if transposed and f"{conv}.bias" in sd:
        out[f"{name}.conv.bias"] = sd[f"{conv}.bias"]
    for stat in _BN_STATS:
        out[f"{name}.bn.{stat}"] = sd[f"{bn}.{stat}"]


def _tensors(sd: Mapping) -> dict:
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def convert_rangenet_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """Upstream's torch ``RangeNet`` state_dict → this module's (RangeNet-53
    when ``enc3`` holds an eighth residual block, else 21)."""
    sd = _tensors(sd)
    nrb = BACKBONES[backbone_of(sd, "enc3.residual_blocks.7")]
    out = {}
    _cbl(out, "stem", sd, "stem.0", "stem.1")

    def block(name, num_blocks, up):
        _cbl(out, f"{name}.conv", sd, f"{name}.conv.0", f"{name}.conv.1", transposed=up)
        for i in range(num_blocks):
            p = f"{name}.residual_blocks.{i}.residual"
            _cbl(out, f"{name}.res{i}.reduce", sd, f"{p}.0.0", f"{p}.0.1")
            _cbl(out, f"{name}.res{i}.expand", sd, f"{p}.1.0", f"{p}.1.1")

    for i, n in enumerate(nrb):
        block(f"enc{i + 1}", n, up=False)
    for i in range(5, 0, -1):
        block(f"dec{i}", 1, up=True)
    out["head.weight"] = sd["head.1.weight"]
    out["head.bias"] = sd["head.1.bias"]
    return {k: v.float().contiguous() for k, v in out.items()}


def backbone_of(sd: Mapping, eighth_block: str = "enc3.residual_7") -> int:
    """53 when a key of ``sd`` names ``enc3``'s eighth residual block, else 21."""
    return 53 if any(eighth_block in k for k in sd) else 21


def convert_rangenet_folder(backbone_sd: Mapping, decoder_sd: Mapping, head: Mapping | None = None):
    """The pretrained folder's darknet-named state_dicts → this module's
    (``num_classes`` 17).  Names: ``conv1/bn1``, ``enc{k}.{conv,bn}``,
    ``enc{k}.residual_{i}.{conv1,bn1,conv2,bn2}``, ``dec{j}.{upconv,bn}``,
    ``dec{j}.residual.*``; ``head`` (the class conv) is optional, since FRID
    stops at the decoder, and is zero without it."""
    b, d = _tensors(backbone_sd), _tensors(decoder_sd)
    out = {}

    def res(name, sd, prefix):
        _cbl(out, f"{name}.reduce", sd, f"{prefix}.conv1", f"{prefix}.bn1")
        _cbl(out, f"{name}.expand", sd, f"{prefix}.conv2", f"{prefix}.bn2")

    _cbl(out, "stem", b, "conv1", "bn1")
    for i, n in enumerate(BACKBONES[backbone_of(b)]):
        _cbl(out, f"enc{i + 1}.conv", b, f"enc{i + 1}.conv", f"enc{i + 1}.bn")
        for j in range(n):
            res(f"enc{i + 1}.res{j}", b, f"enc{i + 1}.residual_{j}")
    for j in range(5, 0, -1):
        conv = f"dec{j}.upconv" if f"dec{j}.upconv.weight" in d else f"dec{j}.conv"
        _cbl(out, f"dec{j}.conv", d, conv, f"dec{j}.bn", transposed=True)
        res(f"dec{j}.res0", d, f"dec{j}.residual")
    if head is not None:
        h = _tensors(head)
        key = "head.1.weight" if "head.1.weight" in h else "1.weight"
        out["head.weight"] = h[key]
        out["head.bias"] = h[key.replace("weight", "bias")]
    else:
        out["head.weight"] = torch.zeros(17, 32, 3, 3)
        out["head.bias"] = torch.zeros(17)
    return {k: v.float().contiguous() for k, v in out.items()}


def to_rangenet_folder(state_dict: Mapping) -> tuple[dict, dict]:
    """This module's state_dict → (``backbone``, ``segmentation_decoder``)
    under the darknet names that :func:`convert_rangenet_folder` reads."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    b, d = {}, {}

    def cbl(dst, name, conv, bn):
        dst[f"{conv}.weight"] = sd[f"{name}.conv.weight"]
        if f"{name}.conv.bias" in sd:
            dst[f"{conv}.bias"] = sd[f"{name}.conv.bias"]
        for stat in _BN_STATS:
            dst[f"{bn}.{stat}"] = sd[f"{name}.bn.{stat}"]

    cbl(b, "stem", "conv1", "bn1")
    for k in range(1, 6):
        cbl(b, f"enc{k}.conv", f"enc{k}.conv", f"enc{k}.bn")
        j = 0
        while f"enc{k}.res{j}.reduce.conv.weight" in sd:
            for part, n in (("reduce", 1), ("expand", 2)):
                cbl(b, f"enc{k}.res{j}.{part}", f"enc{k}.residual_{j}.conv{n}", f"enc{k}.residual_{j}.bn{n}")
            j += 1
        cbl(d, f"dec{k}.conv", f"dec{k}.upconv", f"dec{k}.bn")
        for part, n in (("reduce", 1), ("expand", 2)):
            cbl(d, f"dec{k}.res0.{part}", f"dec{k}.residual.conv{n}", f"dec{k}.residual.bn{n}")
    return b, d
