"""HDiT (``nuscenes-hdit-uncond``): the PyTorch port against the JAX
package's ``models/hdit.py`` on the CPU, with the same numpy-drawn weights
through the weight bridge and the same inputs.

- the static tables exactly: the harmonic-limited RoPE frequencies and the
  neighbour indices (clamped on H, wrapped on W, and clamped on W);
- each block to 1e-5 of max(1, its largest output): RMSNorm, AdaRMSNorm,
  GEGLU, the feed-forward, the mapping network, the cosine self-attention
  (3×9 circular neighbourhood, also on a level narrower than the window,
  and global), a whole ``HDiTBlock``;
- the bridge's names: the attention's (heads, 1) log ``scale`` keeps its
  name while the norms' ``scale`` becomes ``weight``; ``rff_freqs``,
  ``spatial_pe`` and ``expand_{i}_alpha`` land as they are;
- the whole network, narrow (32 base channels, one block a level) at 32x128,
  to 1e-4 of its largest output, and a DDIM@3 sample with the JAX x_T
  injected to 1e-4 relative in L2 (as ``test_torch_port_sampler.py``
  explains);
- bfloat16 serving against the JAX serving cast (``build_sampler_fn``):
  every submodule's output in the dtype of its JAX counterpart (the JAX
  cast rounds ``rff_freqs`` with the parameters, so the time embedding is
  bfloat16, and the stream turns float32 at the first attention output),
  the time embedding within two bfloat16 ulps of the JAX one, and the
  forward to 6e-2 of the largest float32 output as
  ``test_torch_port_bf16.py`` explains.  It is not held to the float32
  forward: the rounded Fourier angles move both packages' bfloat16 output
  away from it (the JAX package's own past the 5e-2 limit here, and far
  past it at rff_std = 1).

The JAX network is compiled once (``jax.jit`` of its ``apply``) and shared
by the module-scoped fixture.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_harness import (  # noqa: F401 (one_torch_thread: autouse)
    BF16_VS_F32_RTOL,
    check_bf16_forward,
    jax_bf16_apply,
    one_torch_thread,
    random_params,
)

import lidarcrafter_tpu.models.hdit as jh
from lidarcrafter_tpu.serving.export import _cast_tree
from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.training.factory import build_diffusion_training as jax_build
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.models import hdit as th
from lidarcrafter_tpu_torch.precision import to_serving_dtype_
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training as torch_build
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, init_random_, load_flax_params

BLOCK_RTOL = 1e-5
STACK_RTOL = 1e-4
RESOLUTION = (32, 128)
BF16_ULP = 2.0**-7  # the largest spacing of bfloat16 values, relative


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def check(flax_mod, torch_mod, jargs, targs, seed=0, rtol=BLOCK_RTOL):
    """Random flax weights into both modules; the outputs of ``flax_mod`` on
    ``jargs`` and ``torch_mod`` on ``targs`` (numpy) to ``rtol`` of
    max(1, the largest output)."""
    ja = [jnp.asarray(a) for a in jargs]
    params = random_params(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0), *ja), seed)
    want = np.asarray(flax_mod.apply(params, *ja))
    load_flax_params(torch_mod, params)
    with torch.no_grad():
        got = torch_mod(*(torch.as_tensor(a) for a in targs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))
    return params


@pytest.mark.parametrize("dh,nh,harm", [(16, 2, 1), (64, 2, 16), (64, 16, 64), (32, 4, 7)])
def test_rope_freqs(dh, nh, harm):
    np.testing.assert_array_equal(th.rope_freqs(dh, nh, harm), jh.rope_freqs(dh, nh, harm))


@pytest.mark.parametrize("H,W,circular", [(32, 256, True), (4, 8, True), (8, 16, False), (2, 4, True)])
def test_neighborhood_indices(H, W, circular):
    got = th.neighborhood_indices(H, W, 3, 9, circular_w=circular)
    want = jh._neighborhood_indices(H, W, 3, 9, circular_w=circular)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rms_norms():
    x, emb = _np(2, 4, 8, 32, scale=3.0), _np(2, 48, seed=1)
    check(jh.RMSNorm(), th.RMSNorm(32), (x,), (x,))
    check(jh.AdaRMSNorm(), th.AdaRMSNorm(32, 48), (x, emb), (x, emb))


def test_geglu_and_feed_forward():
    x, emb = _np(2, 4, 8, 32), _np(2, 48, seed=1)
    check(jh.GEGLU(96), th.GEGLU(32, 96), (x,), (x,))
    check(jh.FeedForward(mid_dim=96), th.FeedForward(32, 48, 96), (x, emb), (x, emb))


def test_mapping_network():
    x = _np(3, 32, scale=2.0)
    check(jh.MappingNetwork(96, depth=2), th.MappingNetwork(32, 96, depth=2), (x,), (x,))


def _coords(H, W):
    c = np.asarray(jh.enc.generate_polar_coords(H, 4 * W), np.float32).reshape(H, 1, W, 4, 2).mean(axis=(1, 3))
    return c


@pytest.mark.parametrize("H,W,nh,kernel,harm", [
    (8, 32, 2, (3, 9), (4, 16)),   # a local level
    (4, 8, 4, (3, 9), (2, 4)),     # narrower than the window: neighbours repeat
    (4, 8, 8, None, (1, 2)),       # the global middle level
])
def test_self_attention(H, W, nh, kernel, harm):
    C = 64
    x, emb = _np(2, H, W, C), _np(2, 48, seed=1)
    c = _coords(H, W)
    jm = jh.SelfAttention(num_heads=nh, rope_max_harmonics=harm, kernel_size=kernel)
    tm = th.SelfAttention(C, 48, nh, torch.as_tensor(c), harm, kernel)
    params = check(jm, tm, (x, c, emb), (x, emb))
    assert params["params"]["scale"].shape == (nh, 1)


def test_hdit_block():
    H, W, C = 8, 32, 64
    x, emb = _np(2, H, W, C), _np(2, 48, seed=1)
    c = _coords(H, W)
    check(jh.HDiTBlock(num_heads=2, attn_type="local", kernel_size=(3, 9), rope_max_harmonics=(4, 16)),
          th.HDiTBlock(C, 48, 2, torch.as_tensor(c), (3, 9), (4, 16), 3.0), (x, c, emb), (x, emb))


class HDiTPair:
    """``nuscenes-hdit-uncond`` at 32x128, 32 base channels, one block a
    level, 32 time channels, built by both packages with shared weights."""

    def __init__(self, seed: int = 0):
        cfgs = []
        for configs in (jcfgs, tcfgs):
            cfg = configs.get_config("nuscenes-hdit-uncond")
            cfg.data.resolution = RESOLUTION
            cfg.model.params.update(base_channels=32, depths=(1, 1, 1, 1), time_embed_channels=32)
            cfgs.append(cfg)
        self.jcfg, self.tcfg = cfgs
        self.jmodel, self.jengine, _ = jax_build(self.jcfg)
        self.tmodel, self.tengine, _ = torch_build(self.tcfg, device="cpu")
        shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, *RESOLUTION, 2)),
                                jnp.zeros((2,)))
        self.params = random_params(shapes, seed)
        load_flax_params(self.tmodel, self.params)


@pytest.fixture(scope="module")
def pair():
    return HDiTPair()


def test_bridge_names(pair):
    sd = flax_to_state_dict(pair.params, pair.tmodel)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), pair.params["params"])
    np.testing.assert_array_equal(sd["down_0_0.attn.scale"].numpy(), p["down_0_0"]["attn"]["scale"])
    np.testing.assert_array_equal(sd["down_0_0.attn.norm.proj.weight"].numpy(),
                                  p["down_0_0"]["attn"]["norm"]["proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["detok_norm.weight"].numpy(), p["detok_norm"]["scale"])
    np.testing.assert_array_equal(sd["timestep_mapping.mlp0_gegelu.dense_0.weight"].numpy(),
                                  p["timestep_mapping"]["mlp0_gegelu"]["Dense_0"]["kernel"].T)
    for name in ("rff_freqs", "spatial_pe", "expand_0_alpha", "expand_2_alpha"):
        np.testing.assert_array_equal(sd[name].numpy(), p[name])
    assert "rff_freqs" in dict(pair.tmodel.named_buffers())  # a buffer, saved with the weights


def test_init_random_fills_the_fourier_frequencies(pair):
    a, b = (init_random_(th.HDiT(RESOLUTION, 2, base_channels=32, time_embed_channels=32, depths=(1, 1, 1, 1)), 3)
            for _ in range(2))
    torch.testing.assert_close(a.rff_freqs, b.rff_freqs, rtol=0, atol=0)
    assert 0.3 < float(a.rff_freqs.std()) < 3.0


def test_hdit_forward_matches_jax(pair):
    x = _np(2, *RESOLUTION, 2, seed=7)
    t = np.array([-3.0, 5.0], np.float32)  # log-SNR, as the sampler passes it
    want = np.asarray(jax.jit(pair.jmodel.apply)(pair.params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = pair.tmodel(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert got.shape == want.shape == (2, *RESOLUTION, 2)
    scale = np.abs(want).max()
    assert scale > 1e-2  # random weights: no zero-initialised output layer
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * scale)


def test_hdit_ddim_sample_matches_jax_with_injected_x_T(pair):
    key = jax.random.PRNGKey(4)
    want = np.asarray(pair.jengine.sample(pair.params, key, batch_size=2, num_steps=3, mode="ddim"))
    x_T = np.array(jax.random.normal(jax.random.split(key)[0], (2, *RESOLUTION, 2), jnp.float32))
    got = pair.tengine.sample(2, 3, mode="ddim", x_T=torch.as_tensor(x_T)).numpy()
    assert np.all(np.isfinite(got))
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.fixture(scope="module")
def served(pair):
    """The pair's engine served in bfloat16, and the JAX weights cast as
    ``build_sampler_fn`` casts them."""
    engine = copy.deepcopy(pair.tengine)
    to_serving_dtype_(engine.model, torch.bfloat16)
    return dataclasses.replace(engine, dtype=torch.bfloat16), _cast_tree(pair.params, jnp.bfloat16)


def test_hdit_bf16_forward_matches_jax(pair, served):
    engine, pbf = served
    x = _np(2, *RESOLUTION, 2, seed=7)
    t = np.array([-3.0, 5.0], np.float32)
    want_f32 = np.asarray(jax.jit(pair.jmodel.apply)(pair.params, jnp.asarray(x), jnp.asarray(t)))
    want_bf16 = np.asarray(jax_bf16_apply(pair.jmodel.apply)(pbf, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = engine.denoise(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    check_bf16_forward(got, want_bf16, want_f32, vs_f32=False)
    # why it is not held to the float32 forward: the JAX bf16 forward is not
    assert np.abs(want_bf16 - want_f32).max() > BF16_VS_F32_RTOL * np.abs(want_f32).max()


def test_hdit_bf16_casts_where_jax_casts(pair, served):
    """Off-grid log-SNRs, so a time input or frequency left unrounded
    moves the time embedding past its limit."""
    engine, pbf = served
    x = _np(2, *RESOLUTION, 2, seed=9)
    t = np.array([-3.1416, 5.4321], np.float32)
    capture = lambda m, method: method == "__call__"  # noqa: E731
    _, state = jax.jit(lambda p, x, t: pair.jmodel.apply(
        p, x.astype(jnp.bfloat16), t.astype(jnp.bfloat16), capture_intermediates=capture,
        mutable=["intermediates"]))(pbf, jnp.asarray(x), jnp.asarray(t))
    want = {".".join(k[:-1]): np.asarray(v[0]) for k, v in traverse_util.flatten_dict(state["intermediates"]).items()}
    got, hooks = {}, []
    for name, m in engine.model.named_modules():
        if name:
            hooks.append(m.register_forward_hook(lambda m, a, out, name=name: got.__setitem__(name, out)))
    try:
        with torch.no_grad():
            engine.denoise(torch.as_tensor(x), torch.as_tensor(t))
    finally:
        for h in hooks:
            h.remove()
    shared = sorted(set(got) & set(want))
    assert {"timestep_mapping", "down_0_0.attn", "mid_0.ffn", "up_0_0"} <= set(shared)
    for name in shared:
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype), name
    assert got["timestep_mapping"].dtype == torch.bfloat16 and got["down_0_0.attn"].dtype == torch.float32
    w = want["timestep_mapping"].astype(np.float32)
    np.testing.assert_allclose(got["timestep_mapping"].float().numpy(), w, rtol=0,
                               atol=2 * BF16_ULP * np.abs(w).max())
