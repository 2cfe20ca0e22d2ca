"""The rest of the JAX model registry and its last options: the PyTorch port
against the JAX package on the CPU, with the same numpy-drawn weights
(through the weight bridge) and the same inputs.

- the spherical-harmonics coordinate encoding exactly, the encodings'
  channel counts, and ``EfficientUNet`` built with its own default (the
  spherical harmonics) against the JAX model to 1e-4, with the discrete
  engine's loss over it (the JAX key chain's draws injected) to 1e-5;
- HDiT's absolute positional embeddings (spherical harmonics, polar
  coordinates, Fourier features: the encoded token coordinates through
  ``ape_linear`` and the mapping network) to 1e-5 against the JAX
  package's parts (its HDiT cannot be traced with them);
- the encoder's ``obj_mask`` condition, OACA's ``norm_first`` /
  ``norm_for_obj_embedding`` / ``channels_scale_for_positional_embedding``
  (0.5 and 2: positional head dims 16 and 64) to 1e-5, and the plain OACA
  at those head dims against the JAX Pallas kernel in interpret mode;
- ``SpatialRescaler`` (bilinear, nearest, the 1x1 channel map),
  ``Identity``, ``CircularConv`` with dilation and ``InstanceNormPlus`` to
  1e-5; ``LiDARGenRefineNet`` to 1e-4 and ``convert_refinenet`` against the
  JAX converter bit for bit;
- the v6 stack with GLIDE attention blocks (``attention_block_type`` set
  through the config): the forward to 1e-4, served in bfloat16 against the
  JAX serving cast (6e-2, as ``test_torch_port_bf16.py``), one
  ``make_train_step`` step against the JAX step (loss 1e-5, gradients 1e-4
  relative L2, as ``test_torch_port_train.py`` reads them), and two steps
  of the ``train`` CLI with ``--set`` served back through
  ``CondFrameGenerator``;
- one HDiT ``make_train_step`` step against JAX, and the v0 stack's
  ``cond_mode=None`` loss with the JAX draws injected.
"""

from __future__ import annotations

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_train import _assert_grads, _capture, _named, _state_dicts, jax_draws
from test_torch_port_zoo import UncondZooPair, _served, zoo_cfgs
from torch_port_harness import (  # noqa: F401 (one_torch_thread: autouse)
    Pair,
    check_bf16_forward,
    jax_bf16_apply,
    one_torch_thread,
    random_params,
    to_torch,
)

import lidarcrafter_tpu.models.easy_unet as jeasy
import lidarcrafter_tpu.models.efficient_unet as jeu
import lidarcrafter_tpu.models.encoding as jenc
import lidarcrafter_tpu.models.hdit as jhdit
import lidarcrafter_tpu.models.layout_encoder as jle
import lidarcrafter_tpu.models.layout_unet as jlu
import lidarcrafter_tpu.models.refinenet as jrn
from lidarcrafter_tpu.diffusion import DiscreteDiffusion as JaxDiscrete
from lidarcrafter_tpu.ops.pallas_attention import _oaca_unfused
from lidarcrafter_tpu.ops.pallas_attention import oaca_attention as jax_oaca
from lidarcrafter_tpu.serving.export import _cast_tree
from lidarcrafter_tpu.training.optim import make_optimizer as j_make_optimizer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu.training.train_step import make_train_step as j_make_train_step
from lidarcrafter_tpu.utils import torch_ckpt as jckpt
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.diffusion import DiscreteDiffusion
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
from lidarcrafter_tpu_torch.kernels import oaca
from lidarcrafter_tpu_torch.models import build_model
from lidarcrafter_tpu_torch.models import easy_unet as teasy
from lidarcrafter_tpu_torch.models import encoding as tenc
from lidarcrafter_tpu_torch.models import hdit as thdit
from lidarcrafter_tpu_torch.models import layout_encoder as tle
from lidarcrafter_tpu_torch.models import layout_unet as tlu
from lidarcrafter_tpu_torch.models import refinenet as trn
from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint
from lidarcrafter_tpu_torch.training.optim import make_optimizer
from lidarcrafter_tpu_torch.training.state import TrainState
from lidarcrafter_tpu_torch.training.train_step import loss_and_grads, make_train_step
from lidarcrafter_tpu_torch.utils import torch_ckpt as tckpt
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, load_flax_params

BLOCK_RTOL = 1e-5
NET_RTOL = 1e-4
RES = (16, 64)
KINDS = ("spherical_harmonics", "polar_coordinates", "fourier_features")


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


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------- encodings


def test_spherical_harmonics_and_every_encoding_match_jax():
    coords = jenc.generate_polar_coords(32, 128).astype(np.float64)
    for levels in range(1, 6):
        np.testing.assert_array_equal(tenc.spherical_harmonics_encoding(coords, levels),
                                      jenc.spherical_harmonics_encoding(coords, levels))
    for kind in (None, *KINDS):
        n = tenc.coords_encoding_channels(kind, (32, 128))
        assert n == jenc.coords_encoding_channels(kind, (32, 128))
        got = tenc.encode_coords(coords, kind, (32, 128))
        want = jenc.encode_coords(coords, kind, (32, 128))
        if kind is None:
            assert got is None and want is None
        else:
            assert got.shape == (32, 128, n)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tenc.encode_coords(coords, "cubic", (32, 128))


def test_efficient_unet_builds_with_its_default_encoding():
    """The constructor's own default, spherical harmonics of levels 5."""
    model = build_model("efficient_unet", in_channels=2, resolution=(32, 128), base_channels=16)
    assert model.coords.shape == (32, 128, 25)
    assert model.in_conv.conv_0.in_channels == 2 + 25


@pytest.fixture(scope="module")
def sh_unet():
    kw = dict(in_channels=2, resolution=RES, base_channels=16, num_residual_blocks=1)
    jmodel, tmodel = jeu.EfficientUNet(**kw), build_model("efficient_unet", **kw).eval()
    x, t = _np(2, *RES, 2, seed=1), np.array([0.2, 0.7], np.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    params = random_params(shapes, 0)
    load_flax_params(tmodel, params)
    return jmodel, tmodel, params, x, t


def test_efficient_unet_spherical_harmonics_matches_jax(sh_unet):
    jmodel, tmodel, params, x, t = sh_unet
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert np.abs(want).max() > 1e-2
    _close(got, want, NET_RTOL)


def test_discrete_loss_over_the_unet_matches_jax(sh_unet):
    """``DiscreteDiffusion.loss`` over the network, the steps and the noise
    drawn by the JAX key chain."""
    jmodel, tmodel, params, _, _ = sh_unet
    T, shape = 100, (2, *RES, 2)
    kw = dict(sampling_shape=shape[1:], num_training_steps=T, noise_schedule="cosine")
    jengine = JaxDiscrete(apply_fn=jmodel.apply, **kw)
    tengine = DiscreteDiffusion(model=tmodel, **kw)
    x_0 = np.clip(_np(*shape, seed=2), -1, 1)
    key = jax.random.PRNGKey(5)
    want = float(jax.jit(jengine.loss)(params, key, jnp.asarray(x_0)))
    rng_t, rng_q = jax.random.split(key)
    steps = np.asarray(jax.random.randint(rng_t, (shape[0],), 0, T))
    noise = np.asarray(jax.random.normal(rng_q, shape, jnp.float32))
    with torch.no_grad():
        got = float(tengine.loss(torch.as_tensor(x_0), steps=torch.as_tensor(steps, dtype=torch.int64),
                                 noise=torch.as_tensor(noise)))
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------- HDiT


def _jax_token_encoding(kind: str, resolution=RES, patch_size=(1, 4)) -> np.ndarray:
    """The JAX HDiT's encoded token coordinates, as its ``__call__``
    computes them (``models/hdit.py``): the polar grid averaged over each
    patch in float32, encoded in float64."""
    (H, W), (ph, pw) = resolution, patch_size
    th, tw = H // ph, W // pw
    c = jnp.asarray(jenc.generate_polar_coords(H, W), jnp.float32).reshape(th, ph, tw, pw, 2).mean(axis=(1, 3))
    return jenc.encode_coords(np.asarray(c, np.float64), kind, (th, tw))


class _JaxAPE(fnn.Module):
    """The rest of the JAX HDiT's absolute positional embedding:
    ``ape_linear`` (no bias) and the mapping network."""

    channels: int
    mlp_ratio: float = 3.0
    depth: int = 2

    @fnn.compact
    def __call__(self, pemb):
        pemb = fnn.Dense(self.channels, use_bias=False, name="ape_linear")(pemb)
        return jhdit.MappingNetwork(int(self.channels * self.mlp_ratio), depth=self.depth,
                                    name="spatial_mapping")(pemb)


@pytest.mark.parametrize("kind", KINDS)
def test_hdit_positional_embedding(kind):
    """The JAX HDiT with an absolute embedding cannot be traced (its
    ``np.asarray`` of the traced token coordinates raises under ``jax.jit``
    and ``eval_shape``), so the embedding is held to the JAX package's own
    parts, and the port's network runs it."""
    kw = dict(resolution=RES, in_channels=2, base_channels=32, time_embed_channels=32, depths=(1, 1, 1, 1),
              positional_embedding=kind)
    model = thdit.HDiT(**kw).eval()
    pemb = _jax_token_encoding(kind)
    assert model.spatial_pe is None and model.pos_encoding.shape == pemb.shape
    np.testing.assert_allclose(model.pos_encoding.numpy(), pemb.astype(np.float32), rtol=0, atol=1e-6)
    jmod = _JaxAPE(32)
    jpemb = jnp.asarray(pemb, jnp.float32)
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jpemb), 3)
    want = np.asarray(jax.jit(jmod.apply)(params, jpemb))
    sd = flax_to_state_dict(params, torch.nn.ModuleDict({"ape_linear": model.ape_linear,
                                                         "spatial_mapping": model.spatial_mapping}))
    model.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = model.spatial_mapping(thdit.dense(model.ape_linear, model.pos_encoding)).numpy()
        x, t = torch.as_tensor(_np(2, *RES, 2, seed=4)), torch.tensor([0.1, 0.9])
        out = model(x, t)
        model.pos_encoding.zero_()  # the embedding reaches the output
        assert float((model(x, t) - out).abs().max()) > 1e-4
    _close(got, want, BLOCK_RTOL)


@pytest.fixture(scope="module")
def hdit_pair():
    return UncondZooPair("nuscenes-hdit-uncond", resolution=RES)


# ---------------------------------------------------------------- encoder, OACA


def test_layout_encoder_obj_mask():
    L, M = 5, 8
    kw = dict(feature_map_size=RES, layout_length=L, hidden_dim=32, output_dim=64, num_layers=1, num_heads=2,
              mask_size_for_layout_object=M, resolution_to_attention=(4,),
              used_condition_types=("obj_class", "obj_bbox", "obj_mask", "is_valid_obj"))
    rnd = np.random.RandomState(6)
    boxes = rnd.uniform(0, 0.5, (2, L, 9)).astype(np.float32)
    boxes[..., -1] = rnd.randint(0, 9, (2, L))
    batch = {"scaled_gt_boxes": boxes, "gt_boxes_2d": rnd.uniform(0, 0.5, (2, L, 4)).astype(np.float32),
             "is_valid_obj": np.ones((2, L), np.float32),
             "obj_mask": (rnd.uniform(size=(2, L, M, M)) > 0.5).astype(np.float32)}
    jmod, tmod = jle.LayoutTransformerEncoder(**kw), tle.LayoutTransformerEncoder(**kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jb), 7)
    assert "obj_mask_embedding" in params["params"]
    want = jax.jit(jmod.apply)(params, jb)
    load_flax_params(tmod, params)
    with torch.no_grad():
        got = tmod(to_torch(batch))
        unmasked = tmod(to_torch(batch | {"obj_mask": 0 * batch["obj_mask"]}))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k], BLOCK_RTOL)
    assert float((got["xf_out"] - unmasked["xf_out"]).abs().max()) > 1e-3  # the mask reaches the tokens


def _oaca_cond(C_enc: int, r: int, L1: int, L: int, seed: int) -> dict:
    return {f"image_patch_bbox_embedding_for_resolution{r}": _np(2, L1, C_enc, seed=seed),
            "obj_bbox_embedding": _np(2, L, C_enc, seed=seed + 1),
            "obj_class_embedding": _np(2, L, C_enc, seed=seed + 2), "xf_out": _np(2, L, C_enc, seed=seed + 3)}


@pytest.mark.parametrize("s,norm_first,norm_obj", [(1.0, True, True), (0.5, False, False), (2.0, True, False)])
def test_oaca_options(s, norm_first, norm_obj):
    """64 channels in 2 heads: positional head dims 32 · s."""
    H, W, C, r = 4, 8, 64, 4
    x = _np(2, H, W, C, seed=8)
    cond = _oaca_cond(64, r, H * W, 13, seed=9)
    opts = dict(channels_scale_for_positional_embedding=s, norm_first=norm_first, norm_for_obj_embedding=norm_obj)
    tmod = tlu.ObjectAwareCrossAttention(C, 2, 64, r, **opts)
    check_jit(jlu.ObjectAwareCrossAttention(num_heads=2, encoder_channels=64, resolution=r, **opts), tmod, (x, cond))
    assert (tmod.norm_for_obj_embedding_gn is not None) == norm_obj
    assert tmod.scale == pytest.approx(float(1 / np.sqrt(np.sqrt(int((1 + s) * C) // 2))))


@pytest.mark.parametrize("dp", [16, 64])
def test_plain_oaca_at_positional_widths_matches_jax(dp):
    rnd = np.random.RandomState(10)
    B, h, Lq, L2, d = 2, 2, 64, 13, 32
    shapes = [(B, h, Lq, d), (B, h, Lq, dp), (B, h, Lq, d), (B, h, L2, d + dp), (B, h, Lq, d), (B, h, L2, d)]
    arrs = [rnd.standard_normal(s).astype(np.float32) for s in shapes]
    scale = float(1 / np.sqrt(np.sqrt(d + dp)))
    want_ref = np.asarray(_oaca_unfused(*map(jnp.asarray, arrs), scale))
    want_kernel = np.asarray(jax_oaca(*map(jnp.asarray, arrs), scale=scale, block_q=64, interpret=True))
    n = oaca.launches.n
    got = oaca.oaca_attention(*(torch.as_tensor(a) for a in arrs), scale=scale).numpy()
    assert oaca.launches.n == n
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=BLOCK_RTOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=BLOCK_RTOL)
    oaca.check_head_dims(d, dp, d)  # an instantiation of the kernel takes it on the card


# ---------------------------------------------------------------- easy_unet, refinenet


@pytest.mark.parametrize("method,strides,out", [("bilinear", ((2, 2), (1, 2)), 4), ("nearest", ((2, 4),), None),
                                                ("bilinear", ((3, 3),), None)])
def test_spatial_rescaler(method, strides, out):
    x = _np(2, 12, 40, 3, seed=11)
    kw = dict(strides=strides, method=method, in_channels=3, out_channels=out)
    if out is None:
        want = np.asarray(jeasy.SpatialRescaler(**kw).apply({}, {"cond": jnp.asarray(x)}))
        got = teasy.SpatialRescaler(**kw)({"cond": torch.as_tensor(x)}).numpy()
        _close(got, want, BLOCK_RTOL)
    else:
        check_jit(jeasy.SpatialRescaler(**kw), teasy.SpatialRescaler(**kw), ({"cond": x},))
    assert teasy.Identity()({"cond": x}) is x


@pytest.mark.parametrize("k,p,dil,bias", [(3, 2, 2, True), (3, 4, 4, False), (1, 0, 1, True)])
def test_circular_conv(k, p, dil, bias):
    x = _np(2, 8, 16, 6, seed=12)
    check_jit(jrn.CircularConv(5, k, p, dil, use_bias=bias), trn.CircularConv(6, 5, k, p, dil, use_bias=bias), (x,))


def test_instance_norm_plus():
    x = _np(2, 8, 16, 6, seed=13, scale=2.0) + 1.0
    check_jit(jrn.InstanceNormPlus(), trn.InstanceNormPlus(6), (x,))


@pytest.fixture(scope="module")
def refinenet():
    kw = dict(in_channels=2, resolution=RES, base_channels=16)
    jmodel, tmodel = jrn.LiDARGenRefineNet(**kw), build_model("refinenet", **kw).eval()
    x = _np(2, *RES, 2, seed=14)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x)), 15)
    load_flax_params(tmodel, params)
    return jmodel, tmodel, params, x


def test_refinenet_matches_jax(refinenet):
    jmodel, tmodel, params, x = refinenet
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(x)).numpy()
    assert np.abs(want).max() > 1e-2
    _close(got, want, NET_RTOL)


def test_refinenet_converter_matches_jax(refinenet):
    _, tmodel, _, _ = refinenet
    up = tckpt.export(tckpt.refinenet, tmodel.state_dict())
    assert "d_block2.0.conv2.0.weight" in up and "d_block2.0.skip.0.weight" in up  # the pooled block
    assert "d_block3.0.conv2.weight" in up and up["d_block1.0.norm1.post_affine.weight"].ndim == 4
    want = flax_to_state_dict(jckpt.convert_refinenet({k: v.numpy() for k, v in up.items()}), tmodel)
    got = tckpt.convert_refinenet(up, tmodel)
    assert set(got) == set(want) == set(tmodel.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], tmodel.state_dict()[k]), k


# ---------------------------------------------------------------- the GLIDE v6 stack

GLIDE = dict(attention_block_type="GLIDEAttentionBlock", channel_mult=(1, 2), attention_ds=(2,))


@pytest.fixture(scope="module")
def glide():
    cfgs = zoo_cfgs("nuscenes-box-layout-v6", resolution=RES, model=GLIDE, cond={"resolution_to_attention": (2,)})
    return Pair("nuscenes-box-layout-v6", small=True, cfgs=cfgs)


def _glide_forward(pair, params, apply):
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    layout = jax.jit(pair.jmodels["cond"].apply)(params["cond"], jbatch)
    return np.asarray(apply(params["model"], jnp.asarray(pair.x), {"time_condition": jnp.asarray(pair.t),
                                                                     "other_condition": layout}))


def test_glide_stack_forward_matches_jax(glide):
    pair = glide
    blocks = [m for m in pair.tmodels["model"].modules() if isinstance(m, tlu.GLIDEAttentionBlock)]
    assert len(blocks) == 4 and all(b.encoder_kv is not None for b in blocks)  # in_1_0, mid, out_1_0/1
    assert not any(isinstance(m, tlu.ObjectAwareCrossAttention) for m in pair.tmodels["model"].modules())
    pair.x = _np(2, *RES, 2, seed=16)
    pair.t = np.array([-3.0, 5.0], np.float32)
    pair.want_f32 = _glide_forward(pair, pair.params, jax.jit(pair.jmodels["model"].apply))
    with torch.no_grad():
        layout = pair.tmodels["cond"](to_torch(pair.batch))
        got = pair.tmodels["model"](torch.as_tensor(pair.x), {"time_condition": torch.as_tensor(pair.t),
                                                              "other_condition": layout}).numpy()
    assert np.abs(pair.want_f32).max() > 1e-2
    _close(got, pair.want_f32, NET_RTOL)


def test_glide_stack_bf16_forward_matches_jax(glide):
    pair = glide
    want_bf16 = _glide_forward(pair, _cast_tree(pair.params, jnp.bfloat16), jax_bf16_apply(pair.jmodels["model"].apply))
    engine = _served(pair.tengine)
    with torch.no_grad():
        cond = engine.get_network_condition(to_torch(pair.batch))
        got = engine.denoise(torch.as_tensor(pair.x), torch.as_tensor(pair.t), cond).numpy()
    check_bf16_forward(got, want_bf16, pair.want_f32)


def _one_step(modules, params, jengine, tengine, jbatch, tbatch, x_shape):
    """One ``make_train_step`` step of each package (the JAX step's draws
    injected into the port's); (port loss, JAX loss, port grads, JAX grads)."""
    lr = 1e-3
    key = jax.random.PRNGKey(7)
    tx = optax.chain(_capture(), j_make_optimizer(lr=lr, warmup_steps=2, num_steps=10))
    ema_kw = dict(ema_update_every=1, ema_update_after_step=0)
    jstep = j_make_train_step(jengine, tx, donate=False, **ema_kw)
    jstate, jloss = jstep(JState.create(params, tx), jbatch, key)
    tstate = TrainState.create(modules, make_optimizer(lr=lr, warmup_steps=2, num_steps=10))
    t, noise, _ = jax_draws(key, 0, x_shape)
    _, grads = loss_and_grads(tengine, tstate.params(), tbatch, t=t, noise=noise)
    names = list(_named(tstate))
    tstep = make_train_step(tengine, make_optimizer(lr=lr, warmup_steps=2, num_steps=10), **ema_kw)
    _, tloss = tstep(tstate, tbatch, 0, t=t, noise=noise)
    return float(tloss), float(jloss), dict(zip(names, grads)), _state_dicts(jstate.opt_state[0], modules)


def _x_0(seed: int = 4):
    return np.clip(0.5 * np.random.RandomState(seed).standard_normal((2, *RES, 2)), -1, 1).astype(np.float32)


def test_glide_stack_train_step_matches_jax(glide):
    pair = glide
    x_0 = _x_0()
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()} | {"x_0": jnp.asarray(x_0)}
    tbatch = {k: torch.as_tensor(v) for k, v in pair.batch.items()} | {"x_0": torch.as_tensor(x_0)}
    tloss, jloss, got, want = _one_step(pair.tmodels, pair.params, pair.jengine, pair.tengine, jbatch, tbatch,
                                        x_0.shape)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert any("encoder_kv" in k for k in want)
    _assert_grads(got, want)


def test_hdit_train_step_matches_jax(hdit_pair):
    p = hdit_pair
    x_0 = _x_0(5)
    tloss, jloss, got, want = _one_step({"model": p.tmodel}, p.params, p.jengine, p.tengine, jnp.asarray(x_0),
                                        torch.as_tensor(x_0), x_0.shape)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    # the Fourier frequencies: a parameter behind stop_gradient in JAX, a buffer here
    assert float(want.pop("model.rff_freqs").abs().max()) == 0.0
    _assert_grads(got, want)


def test_v0_loss_without_concat_matches_jax():
    """The v0 stack trains with ``cond_mode=None``: the layout enters through
    cross-attention and ``xf_proj`` alone."""
    pair = Pair("nuscenes-box-layout", small=True, cfgs=zoo_cfgs("nuscenes-box-layout", resolution=RES,
                                                                 model={"channel_mult": (1, 2, 4),
                                                                        "attention_ds": (4,), "image_size": RES[0]},
                                                                 cond={"resolution_to_attention": (4,)}))
    assert pair.tengine.cond_mode is None
    x_0 = _x_0(6)
    key = jax.random.PRNGKey(11)
    t, noise, _ = jax_draws(key, 3, x_0.shape)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()} | {"x_0": jnp.asarray(x_0)}
    want = float(jax.jit(pair.jengine.loss)(pair.params, jax.random.fold_in(key, 3), jbatch))
    with torch.no_grad():
        got = float(pair.tengine.loss(to_torch(pair.batch) | {"x_0": torch.as_tensor(x_0)}, t=t, noise=noise))
    assert got == pytest.approx(want, rel=1e-5)


def test_glide_stack_trains_and_serves_through_the_cli(tmp_path, capsys):
    out = tmp_path / "run"
    sets = ["--set", 'model.params.attention_block_type="GLIDEAttentionBlock"',
            "--set", "model.params.channel_mult=[1,2]", "--set", "model.params.attention_ds=[2]",
            "--set", "condition_model.params.resolution_to_attention=[2]"]
    train_cli.main(["-c", "nuscenes-box-layout-v6", "--synthetic-data", "--num-steps", "2", "--device", "cpu",
                    "--resolution", *map(str, RES), "--model-channels", "32", "-b", "1", "--checkpoint-every", "2",
                    "--output-dir", str(out), *sets])
    assert "'step': 2" in capsys.readouterr().out
    path = latest_checkpoint(out)
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-box-layout-v6"), resolution=RES, model_channels=32)
    for spec in sets[1::2]:
        tcfgs.apply_override(cfg, spec)
    gen = CondFrameGenerator(cfg, "cpu", ckpt=path)
    assert any(isinstance(m, tlu.GLIDEAttentionBlock) for m in gen.models["model"].modules())
    saved = torch.load(f"{path}/state.pt", weights_only=True)
    for name, value in gen.models["model"].state_dict().items():
        assert torch.equal(value, saved["ema"]["model"][name])
    sample, _ = gen.generate(1, 1, mode="ddim")
    assert sample.shape[-3:-1] == RES and torch.isfinite(sample).all()


def test_registry_builds_the_new_keys():
    assert isinstance(build_model("identity"), teasy.Identity)
    assert isinstance(build_model("easy_unet", strides=((2, 2),)), teasy.SpatialRescaler)
    with pytest.raises(ValueError, match="not a model of the registry"):
        build_model("unet_3d")
    functools.partial(build_model, "refinenet")  # built above at 16x64
