"""Serving precision: the port of the JAX package's bfloat16 inference cast
(``serving/export.py::_cast_tree`` / ``build_sampler_fn``, and ``bench.py``).

There the parameters are cast to ``dtype`` and each denoiser call casts the
image, the time input and the condition tree to ``dtype`` and its
prediction back to float32; schedules, the sampler's carry, clipping and
postprocess stay float32.  The port's engines do the same per call
(``ContinuousDiffusion.dtype``, ``MeanFlow.dtype``); :func:`to_serving_dtype_`
casts a built stack's parameters.
"""

from __future__ import annotations

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_tree(tree, dtype: torch.dtype):
    """The floating tensors of a nested dict / list / tuple cast to
    ``dtype``; every other leaf (bool masks, ints) as it is."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def to_serving_dtype_(model: nn.Module, dtype: torch.dtype, cond_model: nn.Module | None = None) -> None:
    """Cast every floating parameter of the denoiser ``model`` to ``dtype``
    in place, and round those of the condition encoder ``cond_model`` to
    ``dtype``.

    The JAX package casts the encoder's parameters too, but feeds it the
    float32 condition batch, and flax promotes float32 inputs against
    bfloat16 parameters to float32: the encoder computes in float32 with
    rounded weights.  Its parameters are therefore rounded to ``dtype`` and
    kept float32 here, which is that same computation.  Buffers (coordinate
    encodings, FIR taps) stay float32; the models cast them to the
    activations' dtype where they use them, as the JAX package does.
    """
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    if cond_model is not None:
        for p in cond_model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype).float()
