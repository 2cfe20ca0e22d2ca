"""The EfficientUNet family of the PyTorch port against the JAX package on the
CPU: ``FusedGN``, ``AdaGN``, ``ResidualBlock``, the two self-attention
blocks and ``UNetBlock`` one by one, then the whole ``EfficientUNet``
(``nuscenes-unet-uncond``) and ``MFEfficientUNet`` (``meanflow-nusc``) at
reduced size, all with the same numpy-drawn weights through the weight
bridge.  The JAX blocks run as on any CPU: ``nn.dot_product_attention``
stands where the TPU route calls the Pallas kernel (that kernel is held to
the port's attention in ``test_torch_port_attention.py``).

Tolerances, float32:

- blocks, 1e-5 of max(1, the largest output value): a few convolutions or
  matmuls with O(1) values.  The JAX ``FusedGN`` takes one-pass
  ``E[x²] − mean²`` statistics on the CPU and the port direct variance; on
  groups of ≥ 256 elements with mean 3 and variance 4 the two agree to
  ~1e-6, inside the same bound.
- whole UNets, 1e-4 of the largest output: ~40 layers, each adding a few
  f32 ulps in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import UNET_BASE_CHANNELS, UncondPair, check_block, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

import lidarcrafter_tpu.models.efficient_unet as jeu
import lidarcrafter_tpu.models.ops as jops
from lidarcrafter_tpu_torch.configs import get_config
from lidarcrafter_tpu_torch.models import efficient_unet as teu
from lidarcrafter_tpu_torch.models import ops as tops
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training, build_flow_training
from lidarcrafter_tpu_torch.weights import flax_to_state_dict

STACK_RTOL = 1e-4
G, EPS = 8, 1e-6


def _np(*shape, seed=0, scale=1.0, shift=0.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape) + shift).astype(np.float32)


@pytest.mark.parametrize(
    "affine,scale_shift,silu",
    [(True, False, False), (True, False, True), (False, True, True), (True, True, False)],
)
def test_fused_gn(affine, scale_shift, silu):
    B, C = 2, 32
    x = _np(B, 8, 16, C, scale=2.0, shift=3.0)
    ss = (_np(B, 1, 1, C, seed=1, scale=0.3), _np(B, 1, 1, C, seed=2, scale=0.3)) if scale_shift else None
    check_block(
        jops.FusedGN(num_groups=G, epsilon=EPS, use_scale=affine, use_bias=affine),
        tops.FusedGN(C, G, EPS, use_scale=affine, use_bias=affine),
        (x, ss), {"silu": silu},
    )


@pytest.mark.parametrize("silu", [False, True])
def test_ada_gn(silu):
    check_block(
        jops.AdaGN(num_groups=G, eps=EPS),
        tops.AdaGN(32, 64, G, EPS),
        (_np(2, 8, 16, 32, shift=1.0), _np(2, 64, seed=1)), {"silu": silu},
    )


@pytest.mark.parametrize("cin,cout,ring", [(32, 32, True), (32, 64, True), (64, 32, False)])
def test_residual_block(cin, cout, ring):
    check_block(
        jops.ResidualBlock(cout, gn_num_groups=G, gn_eps=EPS, ring=ring),
        tops.ResidualBlock(cin, cout, 64, G, EPS, ring=ring),
        (_np(2, 8, 16, cin), _np(2, 64, seed=1)),
    )


@pytest.mark.parametrize("C,heads", [(64, 2), (128, 8)])
def test_self_attention_2d(C, heads):
    check_block(
        jops.SelfAttention2d(num_heads=heads, gn_num_groups=G, gn_eps=EPS),
        tops.SelfAttention2d(C, heads, G, EPS),
        (_np(2, 4, 16, C),),
    )


@pytest.mark.parametrize("C,heads", [(64, 2), (128, 8)])
def test_mf_self_attention_2d(C, heads):
    check_block(
        jops.MFSelfAttention2d(num_heads=heads, gn_num_groups=G, gn_eps=EPS),
        tops.MFSelfAttention2d(C, heads, G, EPS),
        (_np(2, 4, 16, C),),
    )


@pytest.mark.parametrize(
    "cin,cout,down,up,attn,mf",
    [(16, 32, 2, 1, False, False), (32, 64, 2, 1, True, False), (64, 32, 1, 2, True, False),
     (64, 32, 1, 2, True, True), (32, 16, 1, 1, False, False)],
)
def test_unet_block(cin, cout, down, up, attn, mf):
    kw = dict(gn_num_groups=G, gn_eps=EPS, attn=attn, attn_num_heads=8, up=up, down=down,
              ring=True, mf_attn=mf)
    check_block(
        jeu.UNetBlock(cin, cout, 2, **kw),
        teu.UNetBlock(cin, cout, 2, 64, **kw),
        (_np(2, 8, 32, cin), _np(2, 64, seed=1)),
    )


@pytest.fixture(scope="module", params=["nuscenes-unet-uncond", "meanflow-nusc"])
def pair(request):
    return UncondPair(request.param)


def test_unet_forward_matches_jax(pair):
    B, (H, W) = 2, pair.jcfg.data.resolution
    x = np.random.RandomState(7).standard_normal((B, H, W, 2)).astype(np.float32)
    # log-SNR times for the diffusion UNet; (t, r) in [0, 1] for MeanFlow
    times = [np.array([0.9, 0.4], np.float32), np.array([0.2, 0.1], np.float32)] if pair.flow \
        else [np.array([-3.0, 5.0], np.float32)]
    want = np.asarray(jax.jit(pair.jmodel.apply)(pair.params, jnp.asarray(x), *map(jnp.asarray, times)))
    with torch.no_grad():
        got = pair.tmodel(torch.as_tensor(x), *map(torch.as_tensor, times)).numpy()
    assert got.shape == want.shape == (B, H, W, 2)
    scale = np.abs(want).max()
    assert scale > 1e-2  # random weights, no zero-initialised output layer
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * scale)


def test_reduced_unet_has_the_jax_parameter_count(pair):
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(pair.params))
    assert sum(p.numel() for p in pair.tmodel.parameters()) == n_jax
    assert pair.tcfg.model.params["base_channels"] == UNET_BASE_CHANNELS


@pytest.mark.parametrize("name", ["nuscenes-unet-uncond", "meanflow-nusc"])
def test_full_width_unet_runs_fifty_group_norms_and_two_attention_blocks(name):
    """At full width every denoiser call runs 24 residual blocks x 2 norms
    plus the 2 attention norms through the GroupNorm kernel, and 2 attention
    blocks through the attention kernel (what ``chip_smoke.py`` counts)."""
    build = build_flow_training if name == "meanflow-nusc" else build_diffusion_training
    model, _, _ = build(get_config(name), device="cpu")
    mods = list(model.modules())
    assert sum(isinstance(m, tops.FusedGN) for m in mods) == 50
    attn_cls = tops.MFSelfAttention2d if name == "meanflow-nusc" else tops.SelfAttention2d
    blocks = [m for m in mods if isinstance(m, attn_cls)]
    assert len(blocks) == 2 and [b.num_heads for b in blocks] == [8, 8]
    assert model.d_block4.attn is blocks[0] and model.u_block4.attn is blocks[1]


def test_weight_bridge_converts_dense_general_kernels():
    C, h = 8, 2
    params = {
        name: {"kernel": _np(C, h, C // h, seed=i), "bias": _np(h, C // h, seed=10 + i)}
        for i, name in enumerate(("query", "key", "value"))
    }
    params["out"] = {"kernel": _np(h, C // h, C, seed=3), "bias": _np(C, seed=4)}
    mod = tops.MultiHeadDotProductAttention(C)
    sd = flax_to_state_dict(params, mod)
    np.testing.assert_array_equal(sd["query.weight"].numpy(), params["query"]["kernel"].reshape(C, C).T)
    np.testing.assert_array_equal(sd["key.bias"].numpy(), params["key"]["bias"].reshape(C))
    np.testing.assert_array_equal(sd["out.weight"].numpy(), params["out"]["kernel"].reshape(C, C).T)
    # x·W_q as a (C, h, dh) contraction equals the Linear
    x = _np(3, C, seed=5)
    want = np.einsum("bc,chd->bhd", x, params["query"]["kernel"]).reshape(3, C)
    got = torch.nn.functional.linear(torch.as_tensor(x), sd["query.weight"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_weight_bridge_raises_on_a_left_over_rank3_leaf():
    C, h = 8, 2
    params = {
        name: {"kernel": _np(C, h, C // h), "bias": _np(h, C // h)}
        for name in ("query", "key", "value")
    }
    params["out"] = {"kernel": _np(h, C // h, C), "bias": _np(C)}
    mod = tops.MultiHeadDotProductAttention(C)
    with pytest.raises(KeyError, match="left over"):
        flax_to_state_dict({**params, "extra": {"kernel": _np(C, h, C // h)}}, mod)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict({**params, "out": {"kernel": _np(h, C // h, C + 1), "bias": _np(C)}}, mod)
