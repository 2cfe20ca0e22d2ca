"""Every image-generation config of the registry: the PyTorch port against
the JAX package on the CPU, with the same numpy-drawn weights (through the
weight bridge) and the same inputs.

- the registry: all 15 JAX keys, field for field, and every image config
  built through ``build_diffusion_training`` by both packages with one
  weight tree (the bridge loads it strictly: any module, name or shape the
  two disagree on raises);
- the v0 stack (``nuscenes-box-layout``: ``LayoutUnet`` with zero-padded
  convs, ADM resampling and time embedding, no concat input, OACA at head
  dims 64 through the plain version, its 256-wide-style encoder with no
  ``out_channels``), the v5 encoder (``ObjectGenEncoder`` over
  ``fg_encoding_box`` and the class text table) and the 12-channel
  ``nuscenes-auto-reg`` stack, each encoder output to 1e-5 and each UNet
  output to 1e-4 of its largest value; the v0 blocks to 1e-5;
- ``EfficientUNetCond`` and the engine's ``cond_mode='concat'`` path for an
  encoder that returns a map, and ``kitti-360``'s ``EfficientUNet`` at
  16x128 with its field of view, to 1e-4; ``nearest_interp_2d`` and the
  ray-angle resampling of ``LiDARUtility`` exactly;
- a ``cond_mode=None`` DDIM@5 sample of the v0 stack with the JAX x_T
  injected (1e-4 relative in L2, as ``test_torch_port_sampler.py``
  explains);
- RePaint (``repaint`` and the conditioned ``inpaint``: 2 steps × 2
  resamplings × jump length 2, so both the reverse and the forward jumps
  run) and ``DiscreteDiffusion`` (tables, loss, DDPM and DDIM steps) with
  the JAX key chain's draws injected, over a closed-form denoiser (the
  engines are under test here, the networks above), to 1e-4 relative;
- the plain OACA at head dims 64 against the JAX Pallas kernel in interpret
  mode and ``_oaca_unfused`` (1e-5), and the wrapper's head-dims dispatch;
- the entry points: ``UncondFrameGenerator`` serving HDiT and
  ``kitti-360`` (DDIM and RePaint, the known region held), and
  ``CondFrameGenerator`` serving v5 from a caller-built batch, refusing a
  synthetic one, as the CLI does.

Tolerances: float32; blocks 1e-5 and stacks 1e-4 of max(1, the largest
output) as in ``test_torch_port_model.py``: each layer adds a few f32 ulps
in another summation order.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_harness import (  # noqa: F401 (one_torch_thread: autouse)
    RESOLUTION,
    Pair,
    check_bf16_forward,
    check_block,
    jax_bf16_apply,
    one_torch_thread,
    random_params,
    to_torch,
)

import lidarcrafter_tpu.models.efficient_unet as jeu
import lidarcrafter_tpu.models.layout_unet as jlu
from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.diffusion import CondContinuousDiffusion as JaxCond
from lidarcrafter_tpu.diffusion import ContinuousDiffusion as JaxCont
from lidarcrafter_tpu.diffusion import DiscreteDiffusion as JaxDiscrete
from lidarcrafter_tpu.ops.pallas_attention import _oaca_unfused
from lidarcrafter_tpu.ops.pallas_attention import oaca_attention as jax_oaca
from lidarcrafter_tpu.serving.export import _cast_tree
from lidarcrafter_tpu.training.factory import build_diffusion_training as jax_build
from lidarcrafter_tpu.utils import lidar as jlidar
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.diffusion import CondContinuousDiffusion, ContinuousDiffusion, DiscreteDiffusion
from lidarcrafter_tpu_torch.diffusion.discrete import tables_np
from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
from lidarcrafter_tpu_torch.generate_cond import main as generate_cond_main
from lidarcrafter_tpu_torch.kernels import oaca
from lidarcrafter_tpu_torch.models import efficient_unet as teu
from lidarcrafter_tpu_torch.models import layout_unet as tlu
from lidarcrafter_tpu_torch.precision import to_serving_dtype_
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training as torch_build
from lidarcrafter_tpu_torch.utils import lidar as tlidar
from lidarcrafter_tpu_torch.weights import load_flax_params

BLOCK_RTOL = 1e-5
STACK_RTOL = 1e-4
SAMPLE_L2_RTOL = 1e-4
MODEL_CHANNELS = 32
IMAGE_CONFIGS = sorted(set(tcfgs.__all__) - {"meanflow-nusc", "nuscenes-layout", "nuscenes-object"})


def zoo_cfgs(name: str, resolution=RESOLUTION, model=None, cond=None, **diffusion):
    """``name`` shrunk by the port's ``apply_reduced_topology`` (32
    channels; one encoder layer, one res block a level for the layout
    stacks), then ``model`` / ``cond`` / ``diffusion`` edits; the JAX config
    takes the same values."""
    tcfg = tcfgs.apply_reduced_topology(tcfgs.get_config(name), resolution=resolution, model_channels=MODEL_CHANNELS)
    if tcfg.condition_model is not None:
        tcfg.condition_model.params["num_layers"] = 1
        tcfg.model.params["num_res_blocks"] = 1
        tcfg.condition_model.params.update(cond or {})
    if "base_channels" in tcfg.model.params and tcfg.model.architecture != "hdit":
        tcfg.model.params.update(base_channels=16, num_residual_blocks=(1, 1, 1, 1))
    if tcfg.model.architecture == "hdit":
        tcfg.model.params.update(depths=(1, 1, 1, 1), time_embed_channels=32)
    tcfg.model.params.update(model or {})
    for k, v in diffusion.items():
        setattr(tcfg.diffusion, k, v)
    jcfg = jcfgs.get_config(name)
    jcfg.data = dataclasses.replace(tcfg.data)
    jcfg.model.params = dict(tcfg.model.params)
    jcfg.diffusion = dataclasses.replace(jcfg.diffusion, **dataclasses.asdict(tcfg.diffusion))
    if jcfg.condition_model is not None:
        jcfg.condition_model.params = dict(tcfg.condition_model.params)
    return jcfg, tcfg


class UncondZooPair:
    """An unconditional config built by both packages from ``zoo_cfgs``
    with shared random weights."""

    def __init__(self, name: str, seed: int = 0, **kw):
        self.jcfg, self.tcfg = zoo_cfgs(name, **kw)
        self.jmodel, self.jengine, self.jlu = jax_build(self.jcfg)
        self.tmodel, self.tengine, self.tlu = torch_build(self.tcfg, device="cpu")
        H, W = self.jcfg.data.resolution
        shapes = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, H, W, 2)), jnp.zeros((2,)))
        self.params = random_params(shapes, seed)
        load_flax_params(self.tmodel, self.params)


_V0_EDITS = dict(model={"num_head_channels": 64})  # 64 channels at ds4: one head, OACA dims 64^3


@pytest.fixture(scope="module")
def stacks():
    """The layout stacks under test, each built once."""
    built = {}

    def get(name):
        if name not in built:
            edits = _V0_EDITS if name == "nuscenes-box-layout" else {}
            built[name] = Pair(name, small=True, cfgs=zoo_cfgs(name, **edits))
        return built[name]

    return get


# ---------------------------------------------------------------- registry


def test_registry_holds_every_jax_config():
    assert set(tcfgs.__all__) == set(jcfgs.__all__)
    for name in jcfgs.__all__:
        assert dataclasses.asdict(tcfgs.get_config(name)) == dataclasses.asdict(jcfgs.get_config(name)), name


@pytest.mark.parametrize("name", IMAGE_CONFIGS + ["discrete"])
def test_build_every_image_config(name, stacks):
    """Both packages build the config; one weight tree loads into the port
    strictly; the engines are the same kind."""
    if name == "discrete":
        jcfg, tcfg = zoo_cfgs("nuscenes-unet-uncond", timestep_type="discrete", num_training_steps=100)
        jmodel, jengine, _ = jax_build(jcfg)
        tmodel, tengine, _ = torch_build(tcfg, device="cpu")
        assert isinstance(tengine, DiscreteDiffusion) and tengine.num_training_steps == 100
    elif tcfgs.get_config(name).condition_model is None:
        pair = UncondZooPair(name)
        jengine, tengine = pair.jengine, pair.tengine
    else:
        pair = stacks(name) if name in ("nuscenes-box-layout", "nuscenes-box-layout-v5") else Pair(
            name, small=True, cfgs=zoo_cfgs(name))
        jengine, tengine = pair.jengine, pair.tengine
        assert type(pair.tmodels["model"]).__name__ == type(pair.jmodels["model"]).__name__
        assert type(pair.tmodels["cond"]).__name__ == type(pair.jmodels["cond"]).__name__
        assert tengine.cond_mode == jengine.cond_mode
        assert tengine.w_loss_weight == jengine.w_loss_weight
    assert type(tengine).__name__ == type(jengine).__name__
    assert tuple(tengine.sampling_shape) == tuple(jengine.sampling_shape)


def test_discrete_config_needs_its_step_count():
    """The registry leaves ``num_training_steps`` None; the JAX engine
    cannot build its tables without it, and the port refuses the config."""
    jcfg, tcfg = zoo_cfgs("nuscenes-unet-uncond", timestep_type="discrete")
    assert tcfg.diffusion.num_training_steps is None
    with pytest.raises(TypeError):
        jax_build(jcfg)[1].tables()
    with pytest.raises(ValueError, match="num_training_steps"):
        torch_build(tcfg, device="cpu")


def test_v0_reduced_topology_keeps_the_encoder_as_wide_as_the_unet():
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-box-layout"), model_channels=64)
    assert cfg.condition_model.params["hidden_dim"] == 64
    assert cfg.condition_model.params["output_dim"] == 256
    assert "out_channels" not in cfg.condition_model.params and cfg.diffusion.cond_mode is None
    v6 = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-box-layout-v6"), model_channels=32)
    assert v6.condition_model.params["hidden_dim"] == 64  # v1-v6 keep their encoder
    hdit = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-hdit-uncond"), model_channels=32)
    assert hdit.model.params["base_channels"] == 32


# ---------------------------------------------------------------- stacks


@pytest.mark.parametrize("name", ["nuscenes-box-layout", "nuscenes-box-layout-v5", "nuscenes-auto-reg"])
def test_stack_forward_matches_jax(name, stacks):
    pair = stacks(name)
    B = pair.batch["is_valid_obj"].shape[0]
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    jlayout = jax.jit(pair.jmodels["cond"].apply)(pair.params["cond"], jbatch)
    with torch.no_grad():
        tlayout = pair.tmodels["cond"](to_torch(pair.batch))
    assert set(tlayout) == set(jlayout)
    for k in jlayout:
        want, got = np.asarray(jlayout[k]), tlayout[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_RTOL * max(1.0, np.abs(want).max()), err_msg=k)
    if name == "nuscenes-box-layout":
        assert "concat_cond" not in tlayout
    if name == "nuscenes-auto-reg":  # 11 concat channels + 1 autoregressive
        assert tlayout["concat_cond"].shape[-1] == 12

    x = np.random.RandomState(7).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)
    want = np.asarray(jax.jit(pair.jmodels["model"].apply)(
        pair.params["model"], jnp.asarray(x), {"time_condition": jnp.asarray(t), "other_condition": jlayout}))
    with torch.no_grad():
        got = pair.tmodels["model"](
            torch.as_tensor(x), {"time_condition": torch.as_tensor(t), "other_condition": tlayout}).numpy()
    assert got.shape == want.shape == (B, *pair.jcfg.data.resolution, 2)
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * scale)


def test_v0_stack_runs_oaca_at_head_dims_64(stacks):
    model = stacks("nuscenes-box-layout").tmodels["model"]
    blocks = [m for m in model.modules() if isinstance(m, tlu.ObjectAwareCrossAttention)]
    assert len(blocks) == 4  # one res block a level at this size: in, mid, 2 out
    assert all(m.num_heads == 1 for m in blocks)  # 64 channels at ds4, 64 a head
    assert isinstance(model, tlu.LayoutUnet) and model.coords is None


@pytest.mark.parametrize("updown", ["down", "up", None])
@pytest.mark.parametrize("scale_shift", [True, False])
def test_v0_res_block(updown, scale_shift):
    B, C = 2, 32
    rnd = np.random.RandomState(1)
    x = rnd.standard_normal((B, 8, 16, C)).astype(np.float32)
    emb = rnd.standard_normal((B, 48)).astype(np.float32)
    out = C if updown else 64
    kw = dict(up=updown == "up", down=updown == "down", use_scale_shift_norm=scale_shift)
    got, _ = check_block(
        jlu.ResBlockADM(out_channels=out, ring=False, fir=False, **kw),
        tlu.ResBlockADM(C, out, 48, ring=False, fir=False, **kw),
        (x, emb), rtol=BLOCK_RTOL,
    )
    factor = {"up": 2.0, "down": 0.5, None: 1.0}[updown]
    assert got.shape == (B, int(8 * factor), int(16 * factor), out)


def test_v0_time_embed_upstream_names_round_trip():
    """Upstream v0 checkpoints name the ADM time MLP ``time_embed.0`` /
    ``.2``; the JAX converter reads them into ``time_embed/Dense_0/1`` and
    the bridge lands them on the port's ``time_embed.dense_0/1``."""
    from lidarcrafter_tpu.utils.torch_ckpt import _lin

    rnd = np.random.RandomState(4)
    sd = {"time_embed.0.weight": rnd.standard_normal((128, 32)), "time_embed.0.bias": rnd.standard_normal(128),
          "time_embed.2.weight": rnd.standard_normal((128, 128)), "time_embed.2.bias": rnd.standard_normal(128)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    te = teu.TimeEmbedding(32, 128, adm=True)
    load_flax_params(te, {"Dense_0": _lin(sd, "time_embed.0"), "Dense_1": _lin(sd, "time_embed.2")})
    got = {k: v.numpy() for k, v in te.state_dict().items()}
    for ours, theirs in (("dense_0", "time_embed.0"), ("dense_1", "time_embed.2")):
        for leaf in ("weight", "bias"):
            np.testing.assert_array_equal(got[f"{ours}.{leaf}"], sd[f"{theirs}.{leaf}"])


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("kind", ["Downsample", "Upsample"])
def test_v0_resample_blocks(kind, use_conv):
    x = np.random.RandomState(2).standard_normal((2, 8, 16, 32)).astype(np.float32)
    check_block(
        getattr(jlu, kind)(out_channels=32, use_conv=use_conv, ring=False),
        getattr(tlu, kind)(32, use_conv, ring=False),
        (x,), rtol=BLOCK_RTOL,
    )


def test_adm_time_embedding():
    t = np.array([-7.5, 0.0, 3.25], np.float32)
    check_block(jeu.TimeEmbedding(32, 128, adm=True), teu.TimeEmbedding(32, 128, adm=True), (t,), rtol=BLOCK_RTOL)


def test_v0_ddim_sample_matches_jax_with_injected_x_T(stacks):
    """``cond_mode=None``: the noisy input goes in alone, the layout through
    the condition dict."""
    pair = stacks("nuscenes-box-layout")
    assert pair.tengine.cond_mode is None
    B = pair.batch["is_valid_obj"].shape[0]
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    want = np.asarray(pair.jengine.sample(pair.params, key, jbatch, batch_size=B, num_steps=5, mode="ddim"))
    x_T = np.array(jax.random.normal(jax.random.split(key)[0], (B, *pair.jengine.sampling_shape), jnp.float32))
    got = pair.tengine.sample(to_torch(pair.batch), batch_size=B, num_steps=5, mode="ddim",
                              x_T=torch.as_tensor(x_T)).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert np.linalg.norm(got - want) <= SAMPLE_L2_RTOL * np.linalg.norm(want)


def test_efficient_unet_cond_and_the_concat_engine():
    """``EfficientUNetCond`` reads the timestep from the condition dict; with
    ``cond_mode='concat'`` and an encoder that returns a map, the engine
    concatenates the map onto the noisy input."""
    H, W = 16, 64
    kw = dict(in_channels=5, resolution=(H, W), out_channels=2, base_channels=16,
              num_residual_blocks=(1, 1, 1, 1), coords_encoding="fourier_features")
    rnd = np.random.RandomState(3)
    x = rnd.standard_normal((2, H, W, 5)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)
    jm, tm = jeu.EfficientUNetCond(**kw), teu.EfficientUNetCond(**kw)
    check_block(jm, tm, (x, {"time_condition": t}), rtol=STACK_RTOL)

    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                          {"time_condition": jnp.asarray(t)}), 0)
    load_flax_params(tm, params)
    feat = rnd.standard_normal((2, H, W, 3)).astype(np.float32)
    x_t = rnd.standard_normal((2, H, W, 2)).astype(np.float32)
    jengine = JaxCond(apply_fn=jm.apply, cond_apply_fn=lambda p, d: d["map"], sampling_shape=(H, W, 2),
                      cond_mode="concat")
    cd = {"other_condition": jnp.asarray(feat)}
    want = np.asarray(jengine.predict_x_0_cond(params, jnp.asarray(x_t), cd, jnp.asarray([0.3, 0.7])))

    class MapEncoder(nn.Module):
        def forward(self, batch):
            return batch["map"]

    tengine = CondContinuousDiffusion(model=tm, cond_model=MapEncoder(), sampling_shape=(H, W, 2), cond_mode="concat")
    with torch.no_grad():
        cond = tengine.get_network_condition({"map": torch.as_tensor(feat)})
        got = tengine.predict_x_0(torch.as_tensor(x_t), torch.tensor([0.3, 0.7]), cond).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def kitti():
    return UncondZooPair("kitti-360", resolution=(16, 128))


def test_kitti_360_unet_matches_jax(kitti):
    assert kitti.tcfg.data.fov_up == 3.0 and kitti.tcfg.data.fov_down == -25.0
    rnd = np.random.RandomState(4)
    x = rnd.standard_normal((2, 16, 128, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)
    want = np.asarray(jax.jit(kitti.jmodel.apply)(kitti.params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = kitti.tmodel(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * np.abs(want).max())
    np.testing.assert_allclose(kitti.tlu.ray_angles.numpy(), np.asarray(kitti.jlu.ray_angles), rtol=0, atol=1e-6)
    depth = np.abs(rnd.standard_normal((2, 16, 128, 1))).astype(np.float32) * 30
    np.testing.assert_allclose(kitti.tlu.to_xyz(torch.as_tensor(depth)).numpy(),
                               np.asarray(kitti.jlu.to_xyz(jnp.asarray(depth))), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- bf16 serving


def _served(engine):
    """A copy of ``engine`` served in bfloat16, as the entry points serve it."""
    engine = copy.deepcopy(engine)
    to_serving_dtype_(engine.model, torch.bfloat16, cond_model=getattr(engine, "cond_model", None))
    return dataclasses.replace(engine, dtype=torch.bfloat16)


@pytest.mark.parametrize("name", ["nuscenes-box-layout", "nuscenes-box-layout-v5", "nuscenes-auto-reg"])
def test_stack_bf16_forward_matches_jax(name, stacks):
    """The denoiser served in bfloat16 against the JAX serving cast
    (``build_sampler_fn``: the encoder on float32 inputs with bfloat16
    weights, the denoiser's inputs cast), at the limits
    ``test_torch_port_bf16.py`` explains."""
    pair = stacks(name)
    B = pair.batch["is_valid_obj"].shape[0]
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    x = np.random.RandomState(7).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)

    def jax_forward(params, apply):
        layout = jax.jit(pair.jmodels["cond"].apply)(params["cond"], jbatch)
        return np.asarray(apply(params["model"], jnp.asarray(x),
                                {"time_condition": jnp.asarray(t), "other_condition": layout}))

    model = pair.jmodels["model"]
    want_f32 = jax_forward(pair.params, jax.jit(model.apply))
    want_bf16 = jax_forward(_cast_tree(pair.params, jnp.bfloat16), jax_bf16_apply(model.apply))
    engine = _served(pair.tengine)
    with torch.no_grad():
        cond = engine.get_network_condition(to_torch(pair.batch))
        got = engine.denoise(torch.as_tensor(x), torch.as_tensor(t), cond).numpy()
    check_bf16_forward(got, want_bf16, want_f32)


def test_kitti_360_bf16_forward_matches_jax(kitti):
    x = np.random.RandomState(7).standard_normal((2, 16, 128, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)
    want_f32 = np.asarray(jax.jit(kitti.jmodel.apply)(kitti.params, jnp.asarray(x), jnp.asarray(t)))
    want_bf16 = np.asarray(jax_bf16_apply(kitti.jmodel.apply)(
        _cast_tree(kitti.params, jnp.bfloat16), jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = _served(kitti.tengine).denoise(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    check_bf16_forward(got, want_bf16, want_f32)


@pytest.mark.parametrize("size", [(64, 1024), (32, 1024), (16, 128), (64, 3000)])
def test_nearest_interp_and_ray_angle_resampling(size):
    angles = np.asarray(jlidar.get_hdl64e_linear_ray_angles(64, 2048))
    want = np.asarray(jlidar.nearest_interp_2d(jnp.asarray(angles), size))
    got = tlidar.nearest_interp_2d(torch.as_tensor(angles), size).numpy()
    np.testing.assert_array_equal(got, want)
    jl = jlidar.LiDARUtility.create(size, "log_depth", 1.45, 80.0, ray_angles=jnp.asarray(angles))
    tl = tlidar.LiDARUtility.create(size, "log_depth", 1.45, 80.0, ray_angles=angles)
    np.testing.assert_array_equal(tl.ray_angles.numpy(), np.asarray(jl.ray_angles))


# ---------------------------------------------------------------- engines


class Toy(nn.Module):
    """A closed-form denoiser, w·x + 0.1·time (+ the condition's bias)."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(0.5))

    def forward(self, x, t):
        if isinstance(t, dict):
            return self.w * x + 0.1 * t["time_condition"][:, None, None, None] + t["other_condition"]["bias"]
        return self.w * x + 0.1 * t.float()[:, None, None, None]


class ToyEncoder(nn.Module):
    def forward(self, batch):
        return {"bias": 0.2 * batch["b"]}


def _jax_toy(p, x, t):
    return p["w"] * x + 0.1 * jnp.asarray(t, jnp.float32)[:, None, None, None]


def _jax_draws(key, shape):
    """The normal draws of the JAX RePaint key chain, by (kind, index, k)."""
    rng_init, rng_scan = jax.random.split(key)

    def draw(kind, index, k):
        rng_ij = jax.random.fold_in(rng_scan, index)
        sub = {"known": lambda: jax.random.fold_in(jax.random.fold_in(rng_ij, k), 1),
               "reverse": lambda: jax.random.fold_in(jax.random.fold_in(rng_ij, k), 2),
               "forward": lambda: jax.random.fold_in(rng_ij, 100 + k)}[kind]()
        return torch.as_tensor(np.asarray(jax.random.normal(sub, shape, jnp.float32)))

    return torch.as_tensor(np.asarray(jax.random.normal(rng_init, shape, jnp.float32))), draw


@pytest.mark.parametrize("conditioned", [False, True])
def test_repaint_matches_jax_with_injected_draws(conditioned):
    shape = (2, 4, 8, 2)
    rnd = np.random.RandomState(6)
    known = np.clip(rnd.standard_normal(shape), -1, 1).astype(np.float32)
    mask = (rnd.uniform(size=shape) < 0.5).astype(np.float32)
    bias = (0.1 * rnd.standard_normal(shape)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    schedule = dict(num_steps=2, num_resample_steps=2, jump_length=2)
    params = {"w": jnp.float32(0.5)}
    if conditioned:
        jengine = JaxCond(apply_fn=lambda p, x, cd: _jax_toy(p, x, cd["time_condition"]) + cd["other_condition"]["bias"],
                          cond_apply_fn=lambda p, d: {"bias": 0.2 * d["b"]}, sampling_shape=shape[1:])
        want = jengine.inpaint(params, key, jnp.asarray(known), jnp.asarray(mask), {"b": jnp.asarray(bias)}, **schedule)
    else:
        jengine = JaxCont(apply_fn=_jax_toy, sampling_shape=shape[1:])
        want = jengine.repaint(params, key, jnp.asarray(known), jnp.asarray(mask), **schedule)
    want = np.asarray(want)
    x_T, draw = _jax_draws(key, shape)
    if conditioned:
        tengine = CondContinuousDiffusion(model=Toy(), cond_model=ToyEncoder(), sampling_shape=shape[1:])
        got = tengine.inpaint(torch.as_tensor(known), torch.as_tensor(mask), {"b": torch.as_tensor(bias)},
                              x_T=x_T, draw=draw, **schedule).numpy()
    else:
        tengine = ContinuousDiffusion(model=Toy(), sampling_shape=shape[1:])
        got = tengine.inpaint(torch.as_tensor(known), torch.as_tensor(mask), x_T=x_T, draw=draw, **schedule).numpy()
    assert np.linalg.norm(got - want) <= SAMPLE_L2_RTOL * np.linalg.norm(want)
    # the last paste is the known region at t = 0: known plus sigma(0) = 5.5e-4 noise
    held = mask > 0
    assert np.abs(got[held] - known[held]).max() < 5e-3


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sigmoid"])
def test_discrete_diffusion_matches_jax(schedule):
    T, shape = 50, (4, 4, 8, 2)
    jengine = JaxDiscrete(apply_fn=_jax_toy, sampling_shape=shape[1:], num_training_steps=T, noise_schedule=schedule)
    tengine = DiscreteDiffusion(model=Toy(), sampling_shape=shape[1:], num_training_steps=T, noise_schedule=schedule)
    for got, want in zip(tables_np(schedule, T), jengine.tables()):
        np.testing.assert_array_equal(got, np.asarray(want))
    params = {"w": jnp.float32(0.5)}
    rnd = np.random.RandomState(8)
    x_0 = np.clip(rnd.standard_normal(shape), -1, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = float(jengine.loss(params, key, jnp.asarray(x_0)))
    rng_t, rng_q = jax.random.split(key)
    steps = np.asarray(jax.random.randint(rng_t, (shape[0],), 0, T))
    noise = np.asarray(jax.random.normal(rng_q, shape, jnp.float32))
    with torch.no_grad():
        got = float(tengine.loss(torch.as_tensor(x_0), steps=torch.as_tensor(steps, dtype=torch.int64),
                                 noise=torch.as_tensor(noise)))
    assert abs(got - want) <= SAMPLE_L2_RTOL * abs(want)

    x_t = rnd.standard_normal(shape).astype(np.float32)
    steps = np.array([0, 1, 17, T - 1])  # step 0 adds no noise
    for mode, eta in (("ddpm", 0.0), ("ddim", 0.0), ("ddim", 0.5)):
        want = np.asarray(jengine.p_step(params, key, jnp.asarray(x_t), jnp.asarray(steps), mode=mode, eta=eta))
        noise = torch.as_tensor(np.asarray(jax.random.normal(key, shape, jnp.float32)))
        with torch.no_grad():
            got = tengine.p_step(torch.as_tensor(x_t), torch.as_tensor(steps), mode=mode, eta=eta, noise=noise)
        got = got.numpy()
        assert np.linalg.norm(got - want) <= SAMPLE_L2_RTOL * np.linalg.norm(want), (mode, eta)


# ---------------------------------------------------------------- OACA at head dims 64


@pytest.mark.parametrize("B,h,Lq,L2", [(2, 2, 64, 13), (1, 1, 256, 13), (2, 1, 128, 1)])
def test_oaca_plain_at_head_dims_64_matches_jax(B, h, Lq, L2):
    rnd = np.random.RandomState(0)
    d = 64
    shapes = [(B, h, Lq, d)] * 3 + [(B, h, L2, 2 * d), (B, h, Lq, d), (B, h, L2, d)]
    arrs = [rnd.standard_normal(s).astype(np.float32) for s in shapes]
    scale = float(1 / np.sqrt(np.sqrt(2 * d)))
    want_ref = np.asarray(_oaca_unfused(*map(jnp.asarray, arrs), scale))
    want_kernel = np.asarray(jax_oaca(*map(jnp.asarray, arrs), scale=scale, block_q=min(128, Lq), interpret=True))
    tin = [torch.as_tensor(a) for a in arrs]
    launches = oaca.launches.n
    got = oaca.oaca_attention(*tin, scale=scale).numpy()
    assert oaca.launches.n == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=BLOCK_RTOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=BLOCK_RTOL)


@pytest.mark.parametrize("dims,ok", [
    ((32, 32, 32), True), ((64, 64, 64), True), ((16, 16, 16), False),
    ((64, 64, 32), False), ((32, 32, 64), False), ((128, 128, 128), False),
])
def test_oaca_kernel_head_dims_dispatch(dims, ok):
    if ok:
        oaca.check_head_dims(*dims)
    else:
        with pytest.raises(ValueError, match="head dims"):
            oaca.check_head_dims(*dims)


# ---------------------------------------------------------------- entry points


@pytest.mark.parametrize("name", ["nuscenes-hdit-uncond", "kitti-360"])
def test_uncond_generator_serves_and_inpaints(name):
    _, cfg = zoo_cfgs(name, resolution=(16, 64))
    gen = UncondFrameGenerator(cfg, device="cpu")
    sample, post = gen.generate(2, 2, mode="ddim", seed=1)
    assert sample.shape == (2, 16, 64, 2) and torch.isfinite(sample).all()
    assert torch.isfinite(post["xyz"]).all()
    known = sample.clamp(-1, 1)
    mask = torch.zeros_like(known)
    mask[:, :8] = 1  # keep the top half, fill the bottom
    filled, _ = gen.inpaint(known, mask, num_steps=2, jump_length=2, seed=2)
    assert torch.isfinite(filled).all()
    assert float((filled - known)[:, :8].abs().max()) < 5e-3


def test_v5_is_served_from_a_caller_batch_and_refused_synthetic(stacks, tmp_path):
    pair = stacks("nuscenes-box-layout-v5")
    gen = CondFrameGenerator(pair.tcfg, device="cpu")
    sample, _ = gen.generate(2, 2, mode="ddim", batch=to_torch(pair.batch))
    assert sample.shape == (2, *RESOLUTION, 2) and torch.isfinite(sample).all()
    with pytest.raises(ValueError, match="fg_encoding_box"):
        gen.generate(2, 2, mode="ddim")
    with pytest.raises(SystemExit, match="fg_encoding_box"):
        generate_cond_main(["-c", "nuscenes-box-layout-v5", "--synthetic", "--device", "cpu",
                            "-o", str(tmp_path)])
