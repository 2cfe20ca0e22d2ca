"""``OpenAIUNet`` and GLIDE's attention block: the PyTorch port against the
JAX package on the CPU, with the same numpy-drawn weights (through the
weight bridge) and the same inputs.

- the blocks to 1e-5 of max(1, the largest output): the LDM timestep
  embedding (odd and even widths), ``CrossAttention`` over itself and over
  a context, ``SpatialTransformer`` (GroupNorm eps 1e-6, two transformer
  blocks), and ``GLIDEAttentionBlock`` without and with the encoder's
  tokens prepended to its keys and values;
- two ``OpenAIUNet`` networks at 16x64, 32 channels, to 1e-4: GLIDE blocks
  at the default heads (one head as wide as the block), class-conditional,
  spherical-harmonics coordinates, conv resampling; and SpatialTransformers
  of 16-channel heads over a (B, 5, 24) context, Fourier-feature
  coordinates, up/down ResBlocks;
- ``convert_openai_unet`` against the JAX converter, bit for bit, for both
  networks, on state dicts written by the port's inverse table;
- the plain attention at head dims 256 and 512 and with 13 keys more than
  queries (GLIDE's encoder tokens) against the JAX Pallas kernel in
  interpret mode, and the wrapper's head-dim limit;
- the registry: the port's keys are the JAX package's, and every field of
  each JAX model is a parameter of the port's constructor.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (autouse)

import lidarcrafter_tpu.models.layout_unet as jlu
import lidarcrafter_tpu.models.openai_unet as jou
from lidarcrafter_tpu.models import __all_models__ as JAX_REGISTRY
from lidarcrafter_tpu.ops.pallas_attention import attention_bhld
from lidarcrafter_tpu.utils import torch_ckpt as jckpt
from lidarcrafter_tpu_torch.kernels import attention
from lidarcrafter_tpu_torch.models import _REGISTRY, build_model
from lidarcrafter_tpu_torch.models import layout_unet as tlu
from lidarcrafter_tpu_torch.models import openai_unet as tou
from lidarcrafter_tpu_torch.utils import torch_ckpt as tckpt
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, load_flax_params

BLOCK_RTOL = 1e-5
NET_RTOL = 1e-4
RES = (16, 64)


def check_jit(flax_mod, torch_mod, args, seed=0, rtol=BLOCK_RTOL):
    """Random flax weights → both modules; the jitted JAX output against the
    port's on ``args`` to ``rtol`` of max(1, the largest output value)."""
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    params = random_params(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0), *jargs), seed)
    want = np.asarray(jax.jit(flax_mod.apply)(params, *jargs))
    load_flax_params(torch_mod, params)
    with torch.no_grad():
        got = torch_mod(*jax.tree_util.tree_map(torch.as_tensor, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("dim", [32, 33])
def test_ldm_timestep_embedding(dim):
    t = np.array([0.0, 0.37, 5.0, 999.0], np.float32)
    want = np.asarray(jou.ldm_timestep_embedding(jnp.asarray(t), dim))
    got = tou.ldm_timestep_embedding(torch.as_tensor(t), dim).numpy()
    assert got.shape == want.shape == (4, dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_RTOL)


@pytest.mark.parametrize("context", [False, True])
def test_cross_attention(context):
    x = _np(2, 12, 32, seed=1)
    args = (x, _np(2, 5, 24, seed=2)) if context else (x,)
    check_jit(jou.CrossAttention(num_heads=2, head_dim=16),
              tou.CrossAttention(32, 2, 16, 24 if context else None), args)


def test_spatial_transformer():
    x, ctx = _np(2, 4, 8, 64, seed=3), _np(2, 5, 24, seed=4)
    check_jit(jou.SpatialTransformer(num_heads=4, head_dim=16, depth=2),
              tou.SpatialTransformer(64, 4, 16, depth=2, context_dim=24), (x, ctx))


@pytest.mark.parametrize("heads,encoder", [(2, False), (2, True), (1, False)])
def test_glide_attention_block(heads, encoder):
    """Per-head [q|k|v] packing; with ``encoder``, the 13 encoder tokens'
    K/V prepended to the image's (Lkv = 13 + 32)."""
    x = _np(2, 4, 8, 64, seed=5)
    cond = {"xf_out": _np(2, 13, 48, seed=6)}
    check_jit(jlu.GLIDEAttentionBlock(num_heads=heads, encoder_channels=48 if encoder else None),
              tlu.GLIDEAttentionBlock(64, heads, 48 if encoder else None), (x, cond))


# ---------------------------------------------------------------- networks

NETS = {
    # GLIDE blocks at the default heads (one head as wide as the block)
    "glide": dict(num_classes=3, coords_encoding="spherical_harmonics"),
    "transformer": dict(use_spatial_transformer=True, num_head_channels=16, context_dim=24, transformer_depth=1,
                        coords_encoding="fourier_features", resblock_updown=True),
}
COMMON = dict(resolution=RES, in_channels=2, model_channels=32, out_channels=2, num_res_blocks=1,
              channel_mult=(1, 2, 2), attention_resolutions=(2, 4))


class NetPair:
    def __init__(self, kind: str, seed: int = 0):
        kw = {**COMMON, **NETS[kind]}
        self.kind, self.kw = kind, kw
        self.jmodel = jou.OpenAIUNet(**kw)
        self.tmodel = build_model("openai_unet", **kw).eval()
        B = 2
        self.x = _np(B, *RES, 2, seed=7)
        self.t = np.array([0.3, 0.8], np.float32)
        self.y = np.array([0, 2], np.int32) if kw.get("num_classes") else None
        self.ctx = _np(B, 5, 24, seed=8) if kw.get("context_dim") else None
        cd = {"time_condition": jnp.asarray(self.t)}
        if self.ctx is not None:
            cd["other_condition"] = jnp.asarray(self.ctx)
        self.jcd = cd
        jy = None if self.y is None else jnp.asarray(self.y)
        shapes = jax.eval_shape(functools.partial(self.jmodel.init, y=jy), jax.random.PRNGKey(0),
                                jnp.asarray(self.x), cd)
        self.params = random_params(shapes, seed)
        load_flax_params(self.tmodel, self.params)
        self.want = np.asarray(jax.jit(self.jmodel.apply)(self.params, jnp.asarray(self.x), cd, y=jy))

    def port_forward(self, model=None):
        cd = {"time_condition": torch.as_tensor(self.t)}
        if self.ctx is not None:
            cd["other_condition"] = torch.as_tensor(self.ctx)
        y = None if self.y is None else torch.as_tensor(self.y, dtype=torch.int64)
        with torch.no_grad():
            return (model or self.tmodel)(torch.as_tensor(self.x), cd, y=y).numpy()


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    return NetPair(request.param)


def test_openai_unet_matches_jax(net):
    got = net.port_forward()
    scale = np.abs(net.want).max()
    assert got.shape == net.want.shape == (2, *RES, 2) and scale > 1e-2
    np.testing.assert_allclose(got, net.want, rtol=0, atol=NET_RTOL * scale)


def test_openai_unet_block_kinds(net):
    blocks = {type(m).__name__ for m in net.tmodel.modules()}
    kind = "SpatialTransformer" if net.kind == "transformer" else "GLIDEAttentionBlock"
    assert kind in blocks
    if net.kind == "glide":  # one head as wide as the block: 64 at ds 2, the middle's 64
        heads = {m.num_heads for m in net.tmodel.modules() if isinstance(m, tlu.GLIDEAttentionBlock)}
        assert heads == {1}
        with pytest.raises(ValueError, match="class labels"):
            net.tmodel(torch.as_tensor(net.x), {"time_condition": torch.as_tensor(net.t)})


def test_openai_unet_converter_matches_jax(net):
    """An upstream-format state dict from the port's inverse table, read by
    both converters: the same tensors, bit for bit."""
    arch = {k: net.kw[k] for k in ("channel_mult", "num_res_blocks", "attention_resolutions")}
    arch |= {k: net.kw.get(k, d) for k, d in (("resblock_updown", False), ("use_spatial_transformer", False),
                                              ("transformer_depth", 1))}
    up = tckpt.export(functools.partial(tckpt.openai_unet, **arch), net.tmodel.state_dict())
    assert "time_embed.0.weight" in up and "out.2.weight" in up
    assert any(k.endswith(".qkv.weight") for k in up) != (net.kind == "transformer")
    want = flax_to_state_dict(jckpt.convert_openai_unet({k: v.numpy() for k, v in up.items()}, **arch),
                              net.tmodel)
    got = tckpt.convert_openai_unet(up, net.tmodel, **arch)
    assert set(got) == set(want) == set(net.tmodel.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], net.tmodel.state_dict()[k]), k


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("Lq,Lkv,d", [(64, 64, 256), (64, 64, 512), (64, 77, 32), (128, 141, 64)])
def test_plain_attention_matches_the_pallas_kernel(Lq, Lkv, d):
    """Head dims 256 / 512 (OpenAIUNet's one head at ds 4 / 8) and 13 keys
    more than queries (GLIDE with the encoder's tokens)."""
    B, h = 1, 2
    q, k, v = _np(B, h, Lq, d, seed=9), _np(B, h, Lkv, d, seed=10), _np(B, h, Lkv, d, seed=11)
    c = float(1.0 / np.sqrt(np.sqrt(d)))  # the JAX blocks pre-scale q and k
    want = np.asarray(attention_bhld(jnp.asarray(q) * c, jnp.asarray(k) * c, jnp.asarray(v),
                                     block_q=64, interpret=True))
    n = attention.launches.n
    got = attention.attention(*(torch.as_tensor(a) for a in (q, k, v)), scale=c * c).numpy()
    assert attention.launches.n == n  # the CPU takes the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_RTOL)


def test_attention_head_dim_limit():
    assert attention._MAX_HEAD_DIM == 512


# ---------------------------------------------------------------- registry


def test_registry_keys_and_fields_match_jax():
    assert set(_REGISTRY) == set(JAX_REGISTRY)
    for key, jcls in JAX_REGISTRY.items():
        fields = {f.name for f in dataclasses.fields(jcls)} - {"parent", "name"}
        params = set()
        for cls in _REGISTRY[key].__mro__:
            if "__init__" in vars(cls):
                params |= set(inspect.signature(cls.__init__).parameters)
        assert fields <= params, (key, sorted(fields - params))
