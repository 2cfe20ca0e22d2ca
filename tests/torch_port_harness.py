"""Shared set-up of the parity tests between the JAX package and its PyTorch
port (``tests/test_torch_port_*.py``).

Both packages get the same configs, inputs and weights.  Weights are drawn
from a numpy seed for every leaf of the flax parameter tree (no flax init:
the zero-initialised ``out_conv`` and ``proj_out`` layers would make the
UNet output zeros, and any comparison would pass vacuously) and handed to
the port through its weight bridge.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.serving.export import _cast_tree
from lidarcrafter_tpu.training.factory import build_diffusion_training as jax_build
from lidarcrafter_tpu.training.factory import build_flow_training as jax_build_flow
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training as torch_build
from lidarcrafter_tpu_torch.training.factory import build_flow_training as torch_build_flow
from lidarcrafter_tpu_torch.weights import load_flax_params

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module that imports this fixture.  The
    port's CPU paths are many small ops; beside the other test workers a
    thread per core leaves each op waiting for threads that the load keeps
    off the cores (a rollout that takes 5 s alone took ~230 s beside seven
    busy processes, and 9 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RESOLUTION = (32, 128)
MODEL_CHANNELS = 32
UNET_BASE_CHANNELS = 16  # EfficientUNet width at reduced size (production: 64)


def shrink(configs, name: str, small: bool):
    """``name`` from ``configs`` (either package's) at reduced topology
    through that package's ``apply_reduced_topology`` (32x128, 32 model
    channels), with one encoder layer; with ``small`` also three levels, one
    res block and attention at ds 4 only."""
    cfg = configs.apply_reduced_topology(
        configs.get_config(name), resolution=RESOLUTION, model_channels=MODEL_CHANNELS
    )
    cp, mp = cfg.condition_model.params, cfg.model.params
    cp["num_layers"] = 1
    if small:
        mp.update(channel_mult=(1, 2, 4), num_res_blocks=1, attention_ds=(4,))
        cp["resolution_to_attention"] = (4,)
    return cfg


def random_leaf(path: str, shape: tuple, rnd: np.random.RandomState) -> np.ndarray:
    """kernel: normal/√fan_in; GN/LN/BN scale and qk-norm gains: 1 + 0.1·normal;
    BatchNorm running variance (``batch_stats`` ``var``): 1 + 0.1·|normal|;
    bias, running mean and the rest: 0.1·normal (embeddings: normal/√dim)."""
    z = rnd.standard_normal(shape).astype(np.float32)
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "kernel":
        return z / np.sqrt(np.prod(shape[:-1]))
    if leaf == "var":
        return 1.0 + 0.1 * np.abs(z)
    if leaf == "scale" or leaf.endswith("_norm_g"):
        return 1.0 + 0.1 * z
    if leaf == "embedding":
        return z / np.sqrt(shape[-1])
    return 0.1 * z


def random_params(shape_tree, seed: int):
    rnd = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shape_tree)
    leaves = [
        random_leaf("/".join(str(k.key) for k in p), tuple(s.shape), rnd)
        for p, s in flat
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def condition_batch(cfg, batch_size: int, seed: int) -> dict:
    """numpy condition batch: random boxes with integer classes in the last
    box slot, random concat / autoregressive maps when the encoder declares
    ``out_channels`` (the v0 encoder does not), and the v5 encoder's
    ``fg_encoding_box`` (B, L, 8) and (9, 512) ``fg_text_features`` table."""
    rnd = np.random.RandomState(seed)
    H, W = cfg.data.resolution
    L = cfg.condition_model.params["layout_length"]
    cc = cfg.condition_model.params.get("out_channels", 0)
    boxes = rnd.uniform(0, 0.5, (batch_size, L, 9)).astype(np.float32)
    boxes[..., -1] = rnd.randint(0, 9, (batch_size, L))
    batch = {
        "scaled_gt_boxes": boxes,
        "gt_boxes_2d": rnd.uniform(0, 0.5, (batch_size, L, 4)).astype(np.float32),
        "is_valid_obj": np.ones((batch_size, L), np.float32),
    }
    if cc:
        maps = 0.1 * rnd.standard_normal((batch_size, H, W, cc)).astype(np.float32)
        if "autoregressive" in cfg.data.task:
            batch["concat_cond"], batch["autoregressive_cond"] = maps[..., :-1], maps[..., -1:]
        else:
            batch["concat_cond"] = maps
    if cfg.condition_model.architecture == "layout_encoder_v5":
        batch["fg_encoding_box"] = rnd.uniform(-1, 1, (batch_size, L, 8)).astype(np.float32)
        batch["fg_text_features"] = (0.05 * rnd.standard_normal((9, 512))).astype(np.float32)
    return batch


def check_block(flax_mod, torch_mod, args, kwargs=None, seed=0, rtol=1e-5):
    """Random flax weights → both modules; compare outputs on ``args`` (and
    the non-array ``kwargs``) to ``rtol`` of max(1, the largest output
    value)."""
    kwargs = kwargs or {}
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    shapes = jax.eval_shape(functools.partial(flax_mod.init, **kwargs), jax.random.PRNGKey(0), *jargs)
    params = random_params(shapes, seed)
    want = np.asarray(flax_mod.apply(params, *jargs, **kwargs))
    load_flax_params(torch_mod, params)
    with torch.no_grad():
        got = torch_mod(*jax.tree_util.tree_map(torch.as_tensor, args), **kwargs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))
    return got, want


BF16_VS_JAX_RTOL = 6e-2  # bfloat16 serving: the port against the JAX cast (test_torch_port_bf16.py)
BF16_VS_F32_RTOL = 5e-2  # and against the float32 forward
MIN_BF16_EFFECT = 1e-3


def jax_bf16_apply(apply):
    """``apply(params, x, *rest)`` as ``serving/export.py::build_sampler_fn``
    wraps it: the image and the rest cast to bfloat16, the prediction cast
    back to float32."""
    bf = jnp.bfloat16
    return jax.jit(lambda p, x, *rest: apply(p, x.astype(bf), *_cast_tree(rest, bf)).astype(jnp.float32))


def check_bf16_forward(got, want_bf16, want_f32, vs_f32: bool = True):
    """The port's bfloat16 forward ``got`` against the JAX bfloat16 one to
    ``BF16_VS_JAX_RTOL`` of the largest float32 output, (with ``vs_f32``)
    against the float32 one to ``BF16_VS_F32_RTOL``, and further than
    ``MIN_BF16_EFFECT`` from it: it ran in bfloat16 at all."""
    scale = np.abs(want_f32).max()
    assert got.dtype == np.float32 and got.shape == want_f32.shape
    assert np.all(np.isfinite(got))
    assert np.abs(got - want_bf16).max() <= BF16_VS_JAX_RTOL * scale
    if vs_f32:
        assert np.abs(got - want_f32).max() <= BF16_VS_F32_RTOL * scale
    assert np.abs(got - want_f32).max() > MIN_BF16_EFFECT * scale


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


class Pair:
    """One config built by both packages with shared random weights: ``name``
    shrunk by each package's own ``apply_reduced_topology`` (``shrink``), or
    the given ``(jcfg, tcfg)``."""

    def __init__(self, name: str, small: bool, batch_size: int = 2, seed: int = 0, cfgs=None):
        if cfgs is None:
            cfgs = shrink(jcfgs, name, small), shrink(tcfgs, name, small)
        self.jcfg, self.tcfg = cfgs
        self.jmodels, self.jengine, self.jlu = jax_build(self.jcfg)
        self.tmodels, self.tengine, self.tlu = torch_build(self.tcfg, device="cpu")
        self.batch = condition_batch(self.jcfg, batch_size, seed)
        H, W = self.jcfg.data.resolution
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        cond_shapes = jax.eval_shape(self.jmodels["cond"].init, jax.random.PRNGKey(0), jbatch)
        cond_params = random_params(cond_shapes, seed + 1)
        layout = jax.eval_shape(self.jmodels["cond"].apply, cond_params, jbatch)
        cd = {"time_condition": jnp.zeros((batch_size,)), "other_condition": layout}
        x = jnp.zeros((batch_size, H, W, 2))
        model_shapes = jax.eval_shape(self.jmodels["model"].init, jax.random.PRNGKey(0), x, cd)
        model_params = random_params(model_shapes, seed + 2)
        self.params = {"model": model_params, "cond": cond_params}
        load_flax_params(self.tmodels["cond"], cond_params)
        load_flax_params(self.tmodels["model"], model_params)


class UncondPair:
    """An unconditional config (``nuscenes-unet-uncond`` or the flow config
    ``meanflow-nusc``) built by both packages at reduced size (32x128, 16
    base channels, one residual block per level) with shared random
    weights."""

    def __init__(self, name: str, seed: int = 0):
        self.jcfg, self.tcfg = (
            self._shrink(configs.apply_reduced_topology(configs.get_config(name), resolution=RESOLUTION))
            for configs in (jcfgs, tcfgs)
        )
        self.flow = self.jcfg.flow is not None
        if self.flow:
            self.jmodel, self.jengine, _ = jax_build_flow(self.jcfg)
            self.tmodel, self.tengine, _ = torch_build_flow(self.tcfg, device="cpu")
        else:
            self.jmodel, self.jengine, _ = jax_build(self.jcfg)
            self.tmodel, self.tengine, _ = torch_build(self.tcfg, device="cpu")
        times = (jnp.zeros((2,)),) * (2 if self.flow else 1)
        shapes = jax.eval_shape(
            self.jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, *RESOLUTION, 2)), *times
        )
        self.params = random_params(shapes, seed)
        load_flax_params(self.tmodel, self.params)

    @staticmethod
    def _shrink(cfg):
        cfg.model.params.update(base_channels=UNET_BASE_CHANNELS, num_residual_blocks=(1, 1, 1, 1))
        return cfg
