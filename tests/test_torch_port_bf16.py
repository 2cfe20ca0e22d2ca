"""bfloat16 serving precision: the PyTorch port against the JAX package's
serving cast, with shared weights and inputs, at reduced size.

The JAX side is ``serving/export.py::build_sampler_fn``'s cast: parameters
through ``_cast_tree(params, bfloat16)``, and each denoiser call with the
image, the time input and the condition tree cast to bfloat16 and the
prediction cast back to float32 (``export.py:76-92``, as ``bench.py``
does).  The port's side is ``to_serving_dtype_`` on the stack and the
engines' ``dtype``.

Tolerance.  bfloat16 keeps 8 mantissa bits, a rounding of up to 2^-9 per
operation, through the ~40-60 convolutions, matmuls and norms of a
denoiser, and the two frameworks round in different places: the JAX
package keeps GroupNorm statistics, the residual adds and the attention
softmax in bfloat16 where the port's kernels (and their plain versions)
compute in float32 and round once.  At this size each framework alone lands
up to 4e-2 of the largest float32 output away from the float32 forward, and
the two up to 4e-2 apart.  So the port's bfloat16 forward is held to 6e-2
of the largest float32 output against the JAX package's bfloat16 forward,
and to 5e-2 against the float32 forward (the limit ``chip_smoke.py`` sets
on the card); and it must differ from the float32 forward by more than
1e-3, which shows that it ran in bfloat16 at all.

Those limits are as wide as the effect of the cast itself, so they cannot
show that the port casts where the JAX package casts.  That is checked
where both packages round alike, at a tight limit: what the denoiser
receives (the image and the time input exactly as the JAX cast gives them,
the condition tree's floating leaves bfloat16 within one bfloat16 ulp of
it), and what its time embeddings return, which both packages compute in
float32 from the bfloat16 time and rounded weights, held to 1e-5 as the
condition encoder is (float32 with bfloat16-rounded weights in both).  The
time inputs are chosen off the bfloat16 grid, so a missed time cast moves
the embedding far past that limit.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_harness import (  # noqa: F401 (one_torch_thread: autouse)
    Pair,
    UncondPair,
    check_bf16_forward,
    jax_bf16_apply,
    one_torch_thread,
    to_torch,
)

from lidarcrafter_tpu.models.efficient_unet import TimeEmbedding as JTimeEmbedding
from lidarcrafter_tpu.serving.export import _cast_tree
from lidarcrafter_tpu_torch.models.efficient_unet import TimeEmbedding
from lidarcrafter_tpu_torch.precision import cast_tree, to_serving_dtype_

ENCODER_RTOL = 1e-5  # also the time embeddings: float32 in both packages
BF16_ULP = 2.0**-7  # the largest spacing of bfloat16 values, relative
OFF_GRID_LOG_SNR = np.array([-3.1416, 5.4321], np.float32)  # not bfloat16 values
BF = jnp.bfloat16
B = 2


@pytest.fixture(scope="module")
def layout():
    pair = Pair("nuscenes-box-layout-v6", small=True)
    engine = copy.deepcopy(pair.tengine)
    to_serving_dtype_(engine.model, torch.bfloat16, cond_model=engine.cond_model)
    return pair, dataclasses.replace(engine, dtype=torch.bfloat16)


@pytest.fixture(scope="module", params=["nuscenes-unet-uncond", "meanflow-nusc"])
def uncond(request):
    pair = UncondPair(request.param)
    engine = copy.deepcopy(pair.tengine)
    to_serving_dtype_(engine.model, torch.bfloat16)
    return pair, dataclasses.replace(engine, dtype=torch.bfloat16)


def _jax_layout(pair, params):
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    return pair.jmodels["cond"].apply(params["cond"], jbatch)


def test_encoder_computes_in_float32_with_rounded_weights_as_flax_does(layout):
    pair, engine = layout
    want = _jax_layout(pair, _cast_tree(pair.params, BF))
    with torch.no_grad():
        got = engine.cond_model(to_torch(pair.batch))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k]).astype(np.float32)
        assert got[k].dtype in (torch.float32, torch.bool), k
        np.testing.assert_allclose(got[k].float().numpy(), w, rtol=0,
                                   atol=ENCODER_RTOL * max(1.0, np.abs(w).max()), err_msg=k)
    assert all(p.dtype == torch.bfloat16 for p in engine.model.parameters())


def test_layout_denoiser_forward_in_bf16_matches_jax(layout):
    pair, engine = layout
    x = np.random.RandomState(7).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)
    model = pair.jmodels["model"]
    want_f32 = np.asarray(jax.jit(lambda p, x, cd: model.apply(p, x, cd))(
        pair.params["model"], jnp.asarray(x),
        {"time_condition": jnp.asarray(t), "other_condition": _jax_layout(pair, pair.params)}))
    pbf = _cast_tree(pair.params, BF)
    want_bf16 = np.asarray(jax_bf16_apply(model.apply)(
        pbf["model"], jnp.asarray(x),
        {"time_condition": jnp.asarray(t), "other_condition": _jax_layout(pair, pbf)}))
    with torch.no_grad():
        cond = engine.get_network_condition(to_torch(pair.batch))
        got = engine.denoise(torch.as_tensor(x), torch.as_tensor(t), cond).numpy()
    check_bf16_forward(got, want_bf16, want_f32)


def test_unet_forward_in_bf16_matches_jax(uncond):
    pair, engine = uncond
    x = np.random.RandomState(7).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    times = [np.array([0.9, 0.4], np.float32), np.array([0.2, 0.1], np.float32)] if pair.flow \
        else [np.array([-3.0, 5.0], np.float32)]
    jt = [jnp.asarray(a) for a in times]
    want_f32 = np.asarray(jax.jit(pair.jmodel.apply)(pair.params, jnp.asarray(x), *jt))
    want_bf16 = np.asarray(jax_bf16_apply(pair.jmodel.apply)(_cast_tree(pair.params, BF), jnp.asarray(x), *jt))
    with torch.no_grad():
        tx, tt = torch.as_tensor(x), [torch.as_tensor(a) for a in times]
        if pair.flow:  # the engine's own cast, as MeanFlow.sample makes it
            got = engine.model(tx.bfloat16(), *(a.bfloat16() for a in tt)).float().numpy()
        else:
            got = engine.denoise(tx, tt[0]).numpy()
    check_bf16_forward(got, want_bf16, want_f32)


def _jax_time_embeddings(apply, params, *args):
    """The outputs of the JAX model's time embeddings, by module name."""
    capture = functools.partial(
        apply, capture_intermediates=lambda m, method: isinstance(m, JTimeEmbedding) and method == "__call__",
        mutable=["intermediates"])
    _, state = jax.jit(capture)(params, *args)
    flat = traverse_util.flatten_dict(state["intermediates"])
    return {".".join(k[:-1]): np.asarray(v[0]) for k, v in flat.items()}


def _port_call(engine, run):
    """``run()`` with hooks on ``engine.model``: returns the positional
    inputs of its (one) call and its time embeddings' outputs by name."""
    seen = {"temb": {}}
    hooks = [engine.model.register_forward_pre_hook(lambda m, args: seen.__setitem__("args", args))]
    for name, m in engine.model.named_modules():
        if isinstance(m, TimeEmbedding):
            hooks.append(m.register_forward_hook(
                lambda m, a, out, name=name: seen["temb"].__setitem__(name, out)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return seen["args"], seen["temb"]


def _check_cast(got, want, exact: bool, what: str):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (what, got.dtype, want.dtype)
    g, w = got.float().numpy(), want.astype(np.float32)
    if exact:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-6, err_msg=what)


def _check_time_embeddings(got, want):
    assert set(got) == set(want) and want
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and w.dtype == np.float32, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=ENCODER_RTOL * max(1.0, np.abs(w).max()), err_msg=name)


def test_layout_denoiser_sees_the_jax_serving_cast(layout):
    pair, engine = layout
    x = np.random.RandomState(9).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t = OFF_GRID_LOG_SNR
    pbf = _cast_tree(pair.params, BF)
    jx, jcd = _cast_tree(
        (jnp.asarray(x), {"time_condition": jnp.asarray(t), "other_condition": _jax_layout(pair, pbf)}), BF)
    assert not np.array_equal(np.asarray(jcd["time_condition"]).astype(np.float32), t)
    (got_x, got_cd), temb = _port_call(engine, lambda: engine.denoise(
        torch.as_tensor(x), torch.as_tensor(t), engine.get_network_condition(to_torch(pair.batch))))
    _check_cast(got_x, jx, True, "image")
    _check_cast(got_cd["time_condition"], jcd["time_condition"], True, "time_condition")
    assert set(got_cd["other_condition"]) == set(jcd["other_condition"])
    for k, w in jcd["other_condition"].items():
        _check_cast(got_cd["other_condition"][k], w, False, k)
    _check_time_embeddings(temb, _jax_time_embeddings(pair.jmodels["model"].apply, pbf["model"], jx, jcd))


def test_unet_denoiser_sees_the_jax_serving_cast(uncond):
    """The diffusion engine's denoiser call at off-grid log-SNRs; MeanFlow's
    one step, whose model call takes (z, t = 1, r = 0)."""
    pair, engine = uncond
    x = np.random.RandomState(9).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    if pair.flow:
        times = [np.ones(B, np.float32), np.zeros(B, np.float32)]
        run = lambda: engine.sample(B, z=torch.as_tensor(x))  # noqa: E731
    else:
        times = [OFF_GRID_LOG_SNR]
        run = lambda: engine.denoise(torch.as_tensor(x), torch.as_tensor(times[0]))  # noqa: E731
    jargs = _cast_tree((jnp.asarray(x), *(jnp.asarray(a) for a in times)), BF)
    got_args, temb = _port_call(engine, run)
    assert len(got_args) == len(jargs)
    for i, (g, w) in enumerate(zip(got_args, jargs)):
        _check_cast(g, w, True, f"input {i}")
    _check_time_embeddings(temb, _jax_time_embeddings(pair.jmodel.apply, _cast_tree(pair.params, BF), *jargs))


def test_layout_sampler_step_in_bf16_matches_jax_and_keeps_a_float32_carry(layout):
    """One DDIM step from t = 0.5 to 0.4 (α ≈ 0.7, so x̂_0 does not amplify
    the denoiser's rounding as it does at t = 1)."""
    pair, engine = layout
    x = np.random.RandomState(8).standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t, s = np.full((B,), 0.5, np.float32), np.full((B,), 0.4, np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}

    def jax_step(params, engine_j):
        cd = engine_j.get_network_condition(params, None, jbatch, only_custom=True)
        return np.asarray(engine_j.p_step_cond(
            params, jax.random.PRNGKey(0), jnp.asarray(x), cd, jnp.asarray(t), jnp.asarray(s), mode="ddim"))

    model = pair.jmodels["model"]
    want_f32 = jax_step(pair.params, pair.jengine)
    bf16_engine = dataclasses.replace(pair.jengine, apply_fn=lambda p, x, cd: jax_bf16_apply(
        lambda pm, xx, c: model.apply(pm, xx, c))(p["model"], x, cd))
    want_bf16 = jax_step(_cast_tree(pair.params, BF), bf16_engine)
    with torch.no_grad():
        cond = engine.get_network_condition(to_torch(pair.batch))
        got = engine.p_step(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(s),
                            mode="ddim", condition=cond)
    assert got.dtype == torch.float32
    check_bf16_forward(got.numpy(), want_bf16, want_f32)


def test_uncond_sampler_step_in_bf16_matches_jax_and_keeps_a_float32_carry(uncond):
    """The diffusion engine: one DDIM step from t = 0.5 to 0.4; MeanFlow:
    its one step from injected noise."""
    pair, engine = uncond
    rnd = np.random.RandomState(8)
    x = rnd.standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    jmodel = pair.jmodel
    bf16_engine = dataclasses.replace(pair.jengine, apply_fn=jax_bf16_apply(jmodel.apply))
    pbf = _cast_tree(pair.params, BF)
    if pair.flow:
        key = jax.random.PRNGKey(5)
        want_f32 = np.asarray(pair.jengine.sample(pair.params, key, batch_size=B))
        want_bf16 = np.asarray(bf16_engine.sample(pbf, key, batch_size=B))
        z = np.array(jax.random.normal(key, (B, *pair.jengine.sampling_shape), jnp.float32))
        got = engine.sample(B, z=torch.as_tensor(z))
    else:
        t, s = np.full((B,), 0.5, np.float32), np.full((B,), 0.4, np.float32)
        args = (jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(s))
        want_f32 = np.asarray(pair.jengine.p_step(pair.params, *args, mode="ddim"))
        want_bf16 = np.asarray(bf16_engine.p_step(pbf, *args, mode="ddim"))
        with torch.no_grad():
            got = engine.p_step(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(s), mode="ddim")
    assert got.dtype == torch.float32
    check_bf16_forward(got.numpy(), want_bf16, want_f32)


@pytest.mark.parametrize("mode", ["ddim", "dpmpp_2m"])
def test_bf16_generators_answer_requests_with_float32_samples(mode):
    """The generators' ``dtype``: the denoiser's parameters are bfloat16, the
    sample and its postprocessing float32, and differ from the float32
    generator's."""
    from lidarcrafter_tpu_torch import configs as tcfgs
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator

    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-unet-uncond"), resolution=(32, 128))
    cfg.model.params.update(base_channels=16, num_residual_blocks=(1, 1, 1, 1))
    f32 = UncondFrameGenerator(cfg, device="cpu", weights_seed=1)
    bf16 = UncondFrameGenerator(cfg, device="cpu", weights_seed=1, dtype=torch.bfloat16)
    assert {p.dtype for p in bf16.model.parameters()} == {torch.bfloat16}
    a, post = bf16.generate(B, 2, mode=mode, seed=4)
    b, _ = f32.generate(B, 2, mode=mode, seed=4)
    assert a.dtype == post["xyz"].dtype == torch.float32 and torch.isfinite(a).all()
    assert not torch.equal(a, b)


def test_cast_tree_casts_floating_leaves_only():
    tree = {"a": torch.ones(2), "m": torch.ones(2, dtype=torch.bool), "n": [torch.zeros(1), 3]}
    out = cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["n"][0].dtype == torch.bfloat16
    assert out["m"].dtype == torch.bool and out["n"][1] == 3
