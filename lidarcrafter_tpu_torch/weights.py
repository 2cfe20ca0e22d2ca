"""Weights for the port's modules.

:func:`flax_to_state_dict` turns a flax parameter tree of the JAX package,
given as nested dicts of numpy arrays, into the ``state_dict`` of the port's
counterpart module.  The port's submodules carry the flax names (flax's
auto-names such as ``Conv_0`` / ``Dense_1`` lower-cased), so a path maps
onto a key one to one; the leaves convert as

- Dense ``kernel`` (I, O)      → Linear ``weight`` (O, I)
- DenseGeneral ``kernel`` of multi-head attention: (C, h, dh) of ``query`` /
  ``key`` / ``value`` → Linear ``weight`` (h·dh, C); (h, dh, C) of ``out``
  → Linear ``weight`` (C, h·dh); their ``bias`` (h, dh) → (h·dh,)
- Conv ``kernel`` (H, W, I, O) → Conv2d ``weight`` (O, I, H, W)
- ``scale`` of GroupNorm/LayerNorm/RMSNorm (rank 1) and ``embedding`` of
  Embed → ``weight``; a ``scale`` of any other rank (HDiT's per-head
  attention log scale, (heads, 1)) keeps its name
- ``conv_kernel`` (H, W, O, I) of a transposed conv (the metric extractors'
  ``lax.conv_transpose``) → ``conv.weight`` (I, O, H, W) of a
  ``ConvTranspose2d`` named ``conv``; its ``conv_bias`` → ``conv.bias``
- ``bias`` → ``bias``; any other leaf keeps its name (HDiT's
  ``rff_freqs`` buffer, ``spatial_pe`` and ``expand_{i}_alpha``).

A flax variable dict ``{'params': ..., 'batch_stats': ...}`` carries its
``batch_stats`` collection too: the BatchNorm statistics ``mean`` and
``var`` become the buffers ``running_mean`` and ``running_var``.  The
metric extractors' ``FrozenBN`` keeps the same statistics under
``params``; they become the same buffers.

It raises on a leaf left over, a key missing, or a shape mismatch.

:func:`init_random_` fills a module with seeded random weights (no layer
zero-initialised) and running statistics, for serving and measuring without
a checkpoint.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}  # flax batch_stats → buffers
_COLLECTIONS = {"params", "batch_stats"}


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(path: tuple[str, ...], value, stats: bool = False) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    arr = np.asarray(value)
    if stats and leaf not in _STAT_NAMES:
        raise KeyError(f"batch_stats/{'/'.join(path)}: not a BatchNorm statistic")
    if leaf in _STAT_NAMES:  # in batch_stats, or FrozenBN's under params
        leaf = _STAT_NAMES[leaf]
    elif leaf == "conv_kernel":
        mods, leaf, arr = [*mods, "conv"], "weight", arr.transpose(3, 2, 0, 1)
    elif leaf == "conv_bias":
        mods, leaf = [*mods, "conv"], "bias"
    elif leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3 and mods and mods[-1] == "out":
            arr = arr.reshape(-1, arr.shape[-1]).T
        elif arr.ndim == 3:
            arr = arr.reshape(arr.shape[0], -1).T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    elif leaf == "bias" and arr.ndim == 2:
        arr = arr.reshape(-1)
    # a norm's scale is a vector; any other scale (a per-head log scale) keeps its name
    name = leaf if leaf == "scale" and arr.ndim != 1 else _LEAF_NAMES.get(leaf, leaf)
    key = ".".join([m.lower() for m in mods] + [name])
    return key, np.array(arr, order="C")  # a writable copy (a jax array reads as read-only)


def flax_to_state_dict(params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """Convert ``params`` (a bare parameter tree, or a flax variable dict
    with ``'params'`` and optionally ``'batch_stats'``) into a full
    ``state_dict`` for ``module``."""
    if "params" in params and set(params) <= _COLLECTIONS:
        leaves = [(p, v, c == "batch_stats") for c in sorted(params) for p, v in _flatten(params[c])]
    else:
        leaves = [(p, v, False) for p, v in _flatten(params)]
    expected = module.state_dict()
    out: dict[str, torch.Tensor] = {}
    extra = []
    for path, value, stats in leaves:
        key, arr = _convert_leaf(path, value, stats)
        if key not in expected:
            extra.append("/".join(path))
            continue
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{'/'.join(path)} → {key}: shape {arr.shape} != {tuple(expected[key].shape)}"
            )
        out[key] = torch.as_tensor(arr, dtype=expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if extra or missing:
        raise KeyError(f"flax/torch parameters disagree: left over {extra}, missing {missing}")
    return out


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax parameter tree into ``module`` (strict); returns it."""
    module.load_state_dict(flax_to_state_dict(params, module), strict=True)
    return module


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from ``numpy.random.default_rng(seed)`` in
    ``state_dict`` order: matrices and conv filters normal/√fan_in, norm
    scales 1 + 0.1·normal, biases and other vectors 0.1·normal; then the
    buffers saved with the weights: BatchNorm running means 0.1·normal,
    running variances 1 + 0.1·|normal| (positive), any other floating one
    (HDiT's random Fourier frequencies) standard normal."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        z = rng.standard_normal(shape, dtype=np.float32)
        if p.ndim >= 2:
            value = z / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("weight"):
            value = 1.0 + 0.1 * z
        else:
            value = 0.1 * z
        p.copy_(torch.as_tensor(value))
    saved = module.state_dict(keep_vars=True)
    for name, b in module.named_buffers():
        if name not in saved or not b.is_floating_point():
            continue
        stat = name.rsplit(".", 1)[-1]
        z = rng.standard_normal(tuple(b.shape), dtype=np.float32)
        if stat == "running_var":
            z = 1.0 + 0.1 * np.abs(z)
        elif stat == "running_mean":
            z = 0.1 * z
        b.copy_(torch.as_tensor(z))
    return module
