"""Upstream checkpoint ingestion of the PyTorch port against the JAX
package's, on the CPU, at reduced size.

Two independent routes from one upstream-format engine ``.pth``
(``{'weights', 'ema_weights', 'cfg'}``, the denoiser under ``model.``, the
encoder under ``condition_model.``): the JAX package's
``ingest_checkpoint_for_config`` composed with the port's
``flax_to_state_dict``, and the port's own ``ingest_checkpoint_for_config``.
Each checkpoint is written from seeded port modules through the port's
inverse tables (``to_upstream_checkpoint``), with the online weights 1.0 off
the EMA ones and a few keys that both converters skip; the JAX converters
read the upstream names themselves and raise on a wrong one.  A second,
independent source is ``tests/test_torch_ckpt.py::_fake_layout_unet_sd``,
which replays the reference's block lists on its own (its definition is
read from that file, which cannot be imported without the upstream
checkout).

Held: both routes' ``state_dict`` equal bit for bit for every registry
config that the JAX route ingests, and one forward of each architecture
pair through the JAX module and the port module within 1e-4 of the largest
output; v5 refused by both; the EMA / online choice, the ``ema_model.`` and
bare ``model.`` forms, strictness naming the key, the
``convert_checkpoint`` CLI in-process (a generator's ``ckpt=`` loads its
output bit for bit) and ``apply_override``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import condition_batch, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.training import factory as jfactory
from lidarcrafter_tpu.utils import torch_ckpt as jtc
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import convert_checkpoint as cc
from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator
from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
from lidarcrafter_tpu_torch.utils import torch_ckpt as tc
from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes, synthetic_scene_graphs
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, init_random_

FORWARD_RTOL = 1e-4
RESOLUTION = (32, 128)
INGESTED = sorted(set(tcfgs.__all__) - {"nuscenes-box-layout-v5"})
# one registry config of each architecture pair the JAX route ingests
PAIRS = ["nuscenes-unet-uncond", "meanflow-nusc", "nuscenes-hdit-uncond", "nuscenes-box-layout",
         "nuscenes-box-layout-v6", "nuscenes-layout", "nuscenes-object"]
# upstream keys that no converter reads (written into every test checkpoint)
SKIPPED = {"model.sinusoidal_pos_emb.freqs": torch.ones(4), "global_buffer": torch.zeros(2)}


def reduced(name: str):
    """``name`` at reduced size through the port's ``apply_reduced_topology``
    and a few edits, the JAX config given the same values."""
    tcfg = tcfgs.get_config(name)
    arch = tcfg.model.architecture
    if arch == "unet_1d":  # 128 channels: 2-value groups flip on last-bit differences at 64
        tcfg = tcfgs.apply_reduced_topology(tcfg, model_channels=128)
        tcfg.model.params.update(crossattn_dim=128, concat_dim=128, channel_mult=(1, 1, 1), num_res_blocks=1)
        tcfg.condition_model.params["gconv_num_layers"] = 2
    elif arch == "point_unet":
        tcfg.data.num_samples = 64
    else:
        tcfg = tcfgs.apply_reduced_topology(tcfg, resolution=RESOLUTION, model_channels=32)
        if tcfg.condition_model is not None:
            tcfg.condition_model.params["num_layers"] = 1
            tcfg.model.params["num_res_blocks"] = 1
        if arch == "hdit":
            tcfg.model.params.update(depths=(1, 1, 1, 1), time_embed_channels=32)
        elif "base_channels" in tcfg.model.params:
            tcfg.model.params.update(base_channels=16, num_residual_blocks=(1, 1, 1, 1))
    jcfg = jcfgs.get_config(name)
    jcfg.data = dataclasses.replace(tcfg.data)
    jcfg.model.params = dict(tcfg.model.params)
    if jcfg.condition_model is not None:
        jcfg.condition_model.params = dict(tcfg.condition_model.params)
    return jcfg, tcfg


def seeded_modules(tcfg, seed: int = 0) -> dict:
    mods = tc.build_modules(tcfg, "cpu")
    for i, k in enumerate(sorted(mods)):
        init_random_(mods[k], seed + i)
    return mods


def upstream_pth(tcfg, mods, path: Path, ema_form: bool = False) -> Path:
    """An upstream engine ``.pth`` of ``mods``: EMA weights as they are,
    online weights 1.0 off, the skipped keys in both; with ``ema_form`` the
    EMA module's own state dict (``ema_model.`` in front)."""
    ckpt = tc.to_upstream_checkpoint(tcfg, mods, extra=SKIPPED)
    ckpt["weights"] = {k: v + 1.0 for k, v in ckpt["weights"].items()}
    if ema_form:
        ckpt["ema_weights"] = {"ema_model." + k: v for k, v in ckpt["ema_weights"].items()}
    torch.save(ckpt, path)
    return path


def jax_route(jcfg, path, mods, use_ema: bool = True) -> dict:
    """The JAX package's ingestion, then the port's weight bridge."""
    out = jtc.ingest_checkpoint_for_config(jcfg, str(path), use_ema=use_ema)
    out = out if "model" in out else {"model": out}
    return {k: flax_to_state_dict(out[k], mods[k]) for k in mods}, out


def assert_equal_states(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert set(got[k]) == set(want[k]), k
        for n, v in want[k].items():
            assert got[k][n].dtype == v.dtype and torch.equal(got[k][n], v), f"{k}.{n}"


class Built:
    """A reduced config: seeded port modules and their upstream ``.pth``."""

    def __init__(self, name: str, tmp: Path):
        self.name = name
        self.jcfg, self.tcfg = reduced(name)
        self.mods = seeded_modules(self.tcfg)
        self.path = upstream_pth(self.tcfg, self.mods, tmp / f"{name}.pth")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    cache, tmp = {}, tmp_path_factory.mktemp("upstream")

    def get(name):
        if name not in cache:
            cache[name] = Built(name, tmp)
        return cache[name]

    return get


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("name", INGESTED)
def test_routes_agree_bit_for_bit(name, built):
    b = built(name)
    skipped = []
    got = tc.ingest_checkpoint_for_config(b.tcfg, b.path, skipped=skipped)
    want, _ = jax_route(b.jcfg, b.path, b.mods)
    assert_equal_states(got, want)
    assert_equal_states(got, {k: m.state_dict() for k, m in b.mods.items()})  # the EMA weights, as written
    assert sorted(skipped) == sorted(SKIPPED)


def _load_function(path: Path, name: str):
    """A top-level function of a test file that cannot be imported here."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    scope = {"np": np}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), scope)
    return scope[name]


@pytest.mark.parametrize("temb", ["time_embed.0/2", "time_embed.1/3"])
def test_independent_layout_unet_state_dict(temb, tmp_path):
    """``_fake_layout_unet_sd`` (the JAX tests' own replay of
    ``layout_unet_v1``'s block lists, in both time-MLP forms) through both
    routes into the v6 ``LayoutUnetV1`` at three levels of one res block,
    attention at ds 4: equal bit for bit; a forward of each (first form)
    within 1e-4."""
    fake = _load_function(Path(__file__).with_name("test_torch_ckpt.py"), "_fake_layout_unet_sd")
    jcfg, tcfg = reduced("nuscenes-box-layout-v6")
    for cfg in (jcfg, tcfg):
        cfg.model.params.update(channel_mult=(1, 2, 4), attention_ds=(4,))
        cfg.condition_model.params["resolution_to_attention"] = (4,)
    mods = seeded_modules(tcfg)
    mp = tcfg.model.params
    sd = fake(mc=mp["model_channels"], cm=mp["channel_mult"], nrb=1, attn_ds=mp["attention_ds"],
              enc_ch=tcfg.condition_model.params["hidden_dim"], in_ch=mods["model"].in_conv.conv_0.weight.shape[1],
              out_ch=2, temb=4 * mp["model_channels"])
    if temb == "time_embed.1/3":
        sd = {k.replace("time_embed.2.", "time_embed.3.").replace("time_embed.0.", "time_embed.1."): v
              for k, v in sd.items()}
    enc = tc.to_upstream_checkpoint(tcfg, mods)["ema_weights"]
    engine = {"model." + k: torch.as_tensor(v) for k, v in sd.items()}
    engine.update({k: v for k, v in enc.items() if k.startswith("condition_model.")})
    path = tmp_path / "fake.pth"
    torch.save({"weights": engine}, path)
    got = tc.ingest_checkpoint_for_config(tcfg, path)
    want, jvars = jax_route(jcfg, path, mods)
    assert_equal_states(got, want)
    assert torch.equal(got["model"]["time_embed.dense_1.weight"], engine[f"model.{sd_key(temb)}"])
    if temb == "time_embed.0/2":
        for k, m in mods.items():
            m.load_state_dict(got[k])
        check_forward("nuscenes-box-layout-v6", jcfg, jvars, mods)


def sd_key(temb: str) -> str:
    return "time_embed.2.weight" if temb == "time_embed.0/2" else "time_embed.3.weight"


def test_v5_is_refused_by_both(tmp_path):
    """The JAX converters read only the base encoder's keys: a v5
    checkpoint without ``obj_bbox_embedding`` fails in the JAX converter,
    one with it fails at the port's bridge (the ObjectGenEncoder box
    embedding is left unfilled); the port refuses the config outright."""
    jcfg, tcfg = reduced("nuscenes-box-layout-v5")
    v6 = reduced("nuscenes-box-layout-v6")[1]
    mods = seeded_modules(tcfg)
    base = tc.to_upstream_checkpoint(v6, {"model": mods["model"], "cond": seeded_modules(v6)["cond"]})["ema_weights"]
    v5_box = {f"condition_model.obj_bbox_3d_embedding.{name}.{leaf}": v
              for name, up in (("bbox_proj", "bbox_proj"), ("second0", "second_linear.0"))
              for leaf, v in mods["cond"].get_submodule(f"obj_bbox_3d_embedding.{name}").state_dict().items()}
    for keep_base_box in (False, True):
        sd = {k: v for k, v in base.items() if keep_base_box or "obj_bbox_embedding" not in k} | v5_box
        path = tmp_path / f"v5_{keep_base_box}.pth"
        torch.save({"ema_weights": sd}, path)
        with pytest.raises((KeyError, ValueError)):
            jax_route(jcfg, path, mods)
        with pytest.raises(ValueError, match="layout_encoder_v5"):
            tc.ingest_checkpoint_for_config(tcfg, path)
    with pytest.raises(ValueError, match="layout_encoder_v5"):
        tc.to_upstream_checkpoint(tcfg, mods)


def test_online_weights_and_prefix_forms(built, tmp_path):
    b = built("nuscenes-box-layout-v6")
    online = tc.ingest_checkpoint_for_config(b.tcfg, b.path, use_ema=False)
    assert_equal_states(online, jax_route(b.jcfg, b.path, b.mods, use_ema=False)[0])
    for k, m in b.mods.items():
        for n, v in m.state_dict().items():
            assert torch.equal(online[k][n], v + 1.0), f"{k}.{n}"
    ema_form = upstream_pth(b.tcfg, b.mods, tmp_path / "ema_form.pth", ema_form=True)
    assert_equal_states(tc.ingest_checkpoint_for_config(b.tcfg, ema_form),
                        {k: m.state_dict() for k, m in b.mods.items()})
    u = built("nuscenes-unet-uncond")  # a bare denoiser state dict, no engine prefix
    bare = {k[len("model."):]: v for k, v in tc.to_upstream_checkpoint(u.tcfg, u.mods)["ema_weights"].items()}
    path = tmp_path / "bare.pth"
    torch.save({"weights": bare}, path)
    assert_equal_states(tc.ingest_checkpoint_for_config(u.tcfg, path), jax_route(u.jcfg, path, u.mods)[0])


def test_strictness_names_the_key(built, tmp_path):
    b = built("nuscenes-object")
    sd = tc.to_upstream_checkpoint(b.tcfg, b.mods)["ema_weights"]
    missing = dict(sd)
    del missing["model.layers.3.cond_gate.bias"]
    with pytest.raises(KeyError, match=r"layers\.3\.cond_gate\.bias"):
        tc.ingest_engine_state_dict(b.tcfg, missing)
    wrong = dict(sd, **{"condition_model.second_linear.2.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match=r"second_linear\.2\.weight → second1\.weight"):
        tc.ingest_engine_state_dict(b.tcfg, wrong)
    with pytest.raises(KeyError, match="condition_model"):
        tc.ingest_engine_state_dict(b.tcfg, {k: v for k, v in sd.items() if k.startswith("model.")})
    # an upstream part the module does not hold (OACA's norm_for_obj_embedding) is refused, as at the JAX bridge
    v6 = built("nuscenes-box-layout-v6")
    sd = tc.to_upstream_checkpoint(v6.tcfg, v6.mods)["ema_weights"]
    extra = dict(sd, **{f"model.middle_block.1.norm_for_obj_embedding.{leaf}": torch.ones(64) for leaf in ("weight", "bias")})
    with pytest.raises(KeyError, match=r"norm_for_obj_embedding\.weight → mid_attn\.norm_for_obj_embedding\.weight"):
        tc.ingest_engine_state_dict(v6.tcfg, extra)


# ------------------------------------------------------------------ forward


def check_forward(name, jcfg, jvars, mods) -> None:
    """One forward of the JAX module (``jvars``) and of the port module
    (its loaded weights) on the same seeded inputs, within 1e-4 of the
    largest output."""
    rnd = np.random.RandomState(7)
    arch = jcfg.model.architecture

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape
        scale = float(np.abs(want).max())
        assert scale > 1e-2
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_RTOL * max(1.0, scale))

    with torch.no_grad():
        if jcfg.condition_model is None:
            flow = arch == "mf_efficient_unet"
            jmodel = (jfactory.build_flow_training if flow else jfactory.build_diffusion_training)(jcfg)[0]
            x = rnd.standard_normal((2, *jcfg.data.resolution, 2)).astype(np.float32)
            ts = [np.array([0.3, 0.8], np.float32)] * 2 if flow else [np.array([-3.0, 5.0], np.float32)]
            want = jax.jit(jmodel.apply)(jvars["model"], jnp.asarray(x), *map(jnp.asarray, ts))
            close(mods["model"](torch.as_tensor(x), *map(torch.as_tensor, ts)), want)
            return
        if arch == "unet_1d":
            jmodels = jfactory.build_layout_training(jcfg)[0]
            dec = synthetic_scene_graphs(2, 4, seed=3)["decoder"]
            sg = [dec["objs"], dec["tripltes"], dec["text_feats"], dec["rel_feats"]]
            _, jemb = jax.jit(jmodels["cond"].apply)(jvars["cond"], *map(jnp.asarray, sg))
            _, temb = mods["cond"](*map(torch.as_tensor, sg))
            close(temb, jemb)
            N = len(dec["objs"])
            box = rnd.standard_normal((N, 20)).astype(np.float32)
            t = rnd.uniform(-6, 6, N).astype(np.float32)
            jcd = {"time_condition": jnp.asarray(t), "other_condition": {"preds": jnp.asarray(dec["tripltes"]),
                                                                          "uc_b": jemb}}
            tcd = {"time_condition": torch.as_tensor(t), "other_condition": {"preds": torch.as_tensor(dec["tripltes"]),
                                                                             "uc_b": temb}}
            close(mods["model"](torch.as_tensor(box), tcd), jax.jit(jmodels["model"].apply)(jvars["model"],
                                                                                              jnp.asarray(box), jcd))
            return
        if arch == "point_unet":
            jmodels = jfactory.build_object_training(jcfg)[0]
            boxes = synthetic_object_boxes(2, 3, seed=4)
            jfeat = jax.jit(jmodels["cond"].apply)(jvars["cond"], {k: jnp.asarray(v) for k, v in boxes.items()})
            tfeat = mods["cond"]({k: torch.as_tensor(v) for k, v in boxes.items()})
            close(tfeat, jfeat)
            B, P = len(boxes["fg_class"]), jcfg.data.num_samples
            x = rnd.uniform(-1, 1, (B, P, 4)).astype(np.float32)
            t = rnd.uniform(-6, 6, B).astype(np.float32)
            want = jax.jit(jmodels["model"].apply)(
                jvars["model"], jnp.asarray(x), {"time_condition": jnp.asarray(t), "other_condition": jfeat})
            close(mods["model"](torch.as_tensor(x), {"time_condition": torch.as_tensor(t), "other_condition": tfeat}),
                  want)
            return
        jmodels = jfactory.build_diffusion_training(jcfg)[0]
        batch = condition_batch(jcfg, 2, seed=5)
        jlayout = jax.jit(jmodels["cond"].apply)(jvars["cond"], {k: jnp.asarray(v) for k, v in batch.items()})
        tlayout = mods["cond"]({k: torch.as_tensor(v) for k, v in batch.items()})
        x = rnd.standard_normal((2, *jcfg.data.resolution, 2)).astype(np.float32)
        t = np.array([-3.0, 5.0], np.float32)
        want = jax.jit(jmodels["model"].apply)(
            jvars["model"], jnp.asarray(x), {"time_condition": jnp.asarray(t), "other_condition": jlayout})
        close(mods["model"](torch.as_tensor(x), {"time_condition": torch.as_tensor(t), "other_condition": tlayout}),
              want)


@pytest.mark.parametrize("name", PAIRS)
def test_forward_after_ingestion_matches_jax(name, built):
    b = built(name)
    _, jvars = jax_route(b.jcfg, b.path, b.mods)
    mods = seeded_modules(b.tcfg, seed=100)  # other weights, replaced by the ingested ones
    for k, state in tc.ingest_checkpoint_for_config(b.tcfg, b.path).items():
        mods[k].load_state_dict(state, strict=True)
    check_forward(name, b.jcfg, jvars, mods)


# ---------------------------------------------------------------------- CLI


GENERATORS = {
    "nuscenes-unet-uncond": lambda cfg, ckpt: UncondFrameGenerator(cfg, "cpu", ckpt=ckpt).model,
    "nuscenes-box-layout-v6": lambda cfg, ckpt: CondFrameGenerator(cfg, "cpu", ckpt=ckpt).models,
    "meanflow-nusc": lambda cfg, ckpt: FlowFrameGenerator(cfg, "cpu", ckpt=ckpt).model,
    "nuscenes-layout": lambda cfg, ckpt: LayoutGenerator(cfg, "cpu", ckpt=ckpt).models,
    "nuscenes-object": lambda cfg, ckpt: ObjectGenerator(cfg, "cpu", ckpt=ckpt).models,
}


def overrides(tcfg, name: str) -> list[str]:
    """``--set`` specs that rebuild the reduced config from the registry's."""
    full = tcfgs.get_config(name)
    out = []
    for section in ("data", "model", "condition_model"):
        got, ref = getattr(tcfg, section), getattr(full, section)
        if got is None:
            continue
        if section == "data":
            out += [f"data.{k}={json_of(v)}" for k, v in dataclasses.asdict(got).items()
                    if v != dataclasses.asdict(ref)[k]]
        else:
            out += [f"{section}.params.{k}={json_of(v)}" for k, v in got.params.items() if ref.params.get(k) != v]
    return out


def json_of(v) -> str:
    return json.dumps(list(v) if isinstance(v, tuple) else v)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_cli_output_serves_through_the_generators(name, built, tmp_path, capsys):
    """The CLI in-process (``--set`` rebuilding the reduced config), then
    the generator's ``ckpt=``: the EMA weights (``generate_flow``: the
    online ones, which the CLI writes equal) bit for bit."""
    b = built(name)
    out = tmp_path / "ckpt"
    cc.main(["--torch-ckpt", str(b.path), "-c", name, "-o", str(out), *sum((["--set", s] for s in
                                                                          overrides(b.tcfg, name)), [])])
    printed = capsys.readouterr().out
    assert "strict load into the config's modules: OK" in printed and f"skipped {len(SKIPPED)}" in printed
    served = GENERATORS[name](b.tcfg, str(out))
    served = served if isinstance(served, dict) else {"model": served}
    assert_equal_states({k: m.state_dict() for k, m in served.items()},
                        {k: m.state_dict() for k, m in b.mods.items()})


def test_cli_no_ema_reads_the_online_weights(built, tmp_path):
    b = built("nuscenes-object")
    out = tmp_path / "ckpt"
    cc.main(["--torch-ckpt", str(b.path), "-c", "nuscenes-object", "-o", str(out), "--no-ema", "--no-validate",
             "--set", f"data.num_samples={b.tcfg.data.num_samples}"])
    assert torch.is_grad_enabled()  # the CLI leaves an in-process caller's grad mode as it was
    served = ObjectGenerator(b.tcfg, "cpu", ckpt=str(out)).models
    for k, m in served.items():
        for n, v in m.state_dict().items():
            assert torch.equal(v, b.mods[k].state_dict()[n] + 1.0), f"{k}.{n}"


def test_apply_override_keeps_tuples():
    cfg = tcfgs.get_config("nuscenes-unet-uncond")
    cc.apply_override(cfg, "model.params.base_channels=24")
    assert cfg.model.params["base_channels"] == 24
    cc.apply_override(cfg, "data.resolution=[8,16]")
    assert cfg.data.resolution == (8, 16)
    cc.apply_override(cfg, "model.params.channel_multiplier=[1,2]")
    assert cfg.model.params["channel_multiplier"] == (1, 2)
