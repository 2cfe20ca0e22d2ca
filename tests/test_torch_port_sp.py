"""The port's ``sp`` (azimuth) axis (``parallel/mesh.py``) on the CPU.

(a) The shard map: for 8 virtual devices on a (4, 2) and a (2, 4) mesh, the
    JAX package's ``batch_sharding(mesh, 4, sp_axis=2)`` gives device r the
    slices that the port's mesh gives rank r.
(b) Four gloo ranks (``torch_port_sp_ranks.py``, started once for the
    module) run every sharded case on a (2, 2) and a (1, 4) mesh:
    ``ring_pad`` and ``RingConv`` (ring and zero-padded), ``Resample`` up and
    down, v0's zero-padded ``Downsample`` / ``Upsample``, ``FusedGN``,
    ``AdaGN``, ``SelfAttention2d``, ``MFSelfAttention2d`` (qk-norm, keys
    gathered after it), ``GLIDEAttentionBlock`` (13 encoder tokens in
    front), ``SpatialTransformer`` (over a context, and over itself twice)
    and HDiT's neighbourhood and global ``SelfAttention`` at sp = 2 and 4,
    gathered, equal the layer in one process to 1e-6 of max(1, max |out|),
    and so do the input's gradient and each parameter's (summed over the
    ranks; 1e-6 relative L2).  The forward-mode cases ("... jvp": the halo
    through ``ring_pad``, ring and zero-padded, ``gather_w``, ``sum_sp``,
    ``gather_sp`` through the split ``FusedGN`` / ``AdaGN``, and
    ``MFSelfAttention2d``) hold the tangent under ``torch.func.jvp`` and
    under a ``forward_ad`` dual to the one-process jvp (1e-6 of max(1,
    max |tangent|)), and the gradients through the dual's primal as above.
    The small stacks at sp = 2
    (``torch_port_harness``'s ``UncondPair`` / ``Pair`` weights: uncond,
    auto-reg-v2, v0 with one head of 64 so that OACA runs at 64³, GLIDE v6;
    HDiT; ``OpenAIUNet`` with GLIDE blocks and with transformers; MeanFlow)
    equal the JAX forward of the whole image to 1e-4 and the port's
    one-process forward to 1e-5; HDiT with an absolute (spherical-harmonics)
    embedding, which the JAX package cannot trace (ROADMAP Queue 3 item 18),
    equals the one-process forward to 1e-5 on seeded weights
    (``weights.init_random_``).
    A DDIM@2 sample of uncond and auto-reg-v2 on the mesh equals the
    one-process sample bit for bit when the sharded GroupNorms take their
    statistics from the gathered activations (the control: every other op
    of the sharded path is exact), HDiT's (no statistics to merge) as it
    is; with the merged partials it agrees to 2e-2, the JAX package's own limit for its ``sp`` sample
    (``__graft_entry__.py``): DDIM's first step divides by α(t = 1) ≈
    5.5e-4, which turns the merge's float32 rounding (~1e-6 of the
    denoiser's output) into ~1e-3 on the few pixels it leaves unclipped.
    One train step of auto-reg-v2 and of v0, and the discrete engine's loss
    over the uncond stack, on the (2, 2) mesh with a loss mask whose shards
    hold different counts equal one process: loss 1e-5, gradients 1e-4
    relative L2.  One step of ``LayoutTrainer`` and ``ObjectTrainer`` on a
    (2, 2) group, whose ``sp`` ranks replicate, equals the step in one
    process on the whole batch (loss 1e-5, gradients 1e-4).
    MeanFlow (the reduced ``meanflow-nusc``): the tangent du/dt along
    (v, 1, 0) on the (2, 2) mesh equals one process's (1e-5), a call's
    exchanges under ``torch.func.jvp`` are at most twice those without a
    tangent and a ``forward_ad`` dual's as many as without; the one-step
    sample on the mesh equals one process's (bit for bit with the
    statistics of the gathered activations, 1e-5 with the merged partials);
    a step with the JAX key chain's draws injected equals one process (loss
    1e-5, gradients 1e-4 relative L2) and the JAX ``FlowTrainer`` step on
    an 8-virtual-device (4, 2) CPU mesh (loss 1e-5 relative, gradients as
    ``test_torch_port_flow_train.py`` holds them); ``train.py --sp 2
    --synthetic-data`` on the (2, 2) group logs the losses of one process.
(c) The plain GroupNorm split, ``partials`` → merge → ``apply``, equals
    ``group_norm_plain``, and its tangent (forward-mode autograd of the
    plain split, and the card Functions' closed-form rules
    ``group_norm_partials_jvp`` → merge → ``group_norm_apply_jvp``) equals
    ``group_norm_jvp``, and stays as close to a float64 tangent as one
    process's where the mean is 300 σ; the plain OACA at head dims 32³ and
    64³ with image keys of their own length and positional rows equals the
    JAX ``oaca_attention``'s XLA path on the gathered operands, a shard of
    queries at a time.
(d) ``train.py --sp`` takes every registry config (and the GLIDE,
    ``OpenAIUNet`` and discrete variants), refuses a denoiser that is not
    sp-aware by name, and refuses widths that do not split into even
    shards.
(e) ``draws.Rows`` with a ``Columns`` window: the ranks' cuts tile the
    one-process draw.

One torch thread in each process (the test's and the ranks').
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_layout import small as layout_small
from test_torch_port_object import small as object_small
from test_torch_port_openai_unet import NetPair
from test_torch_port_train import _assert_grads, _capture, _state_dicts
from test_torch_port_zoo import UncondZooPair, zoo_cfgs
from test_torch_port_zoo_rest import GLIDE
from torch_port_harness import Pair, UncondPair, condition_batch, one_torch_thread  # noqa: F401 (autouse)

from lidarcrafter_tpu.ops.pallas_attention import _oaca_unfused
from lidarcrafter_tpu.parallel import batch_sharding as jax_batch_sharding
from lidarcrafter_tpu.parallel import make_mesh as jax_make_mesh
from lidarcrafter_tpu.training.loop import FlowTrainer as JFlowTrainer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.kernels.groupnorm import (
    group_norm_apply_jvp,
    group_norm_apply_plain,
    group_norm_jvp,
    group_norm_partials_jvp,
    group_norm_partials_plain,
    group_norm_plain,
)
from lidarcrafter_tpu_torch.kernels.oaca import oaca_attention_plain
from lidarcrafter_tpu_torch.parallel.mesh import batch_sharding, make_mesh

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
LAYERS = ("ring_pad", "RingConv", "Resample up", "Resample down", "FusedGN", "AdaGN", "SelfAttention2d",
          "ring_pad zeros", "RingConv zeros", "Downsample zeros", "Upsample zeros", "GLIDEAttentionBlock",
          "SpatialTransformer", "SpatialTransformer self", "HDiT neighbourhood", "HDiT global",
          "MFSelfAttention2d", "ring_pad jvp", "ring_pad zeros jvp", "gather_w jvp", "sum_sp jvp", "FusedGN jvp",
          "AdaGN jvp", "MFSelfAttention2d jvp")
SAMPLED = ("nuscenes-unet-uncond", "nuscenes-auto-reg-v2", "nuscenes-hdit-uncond")  # also sampled with DDIM@2
FLOW = "meanflow-nusc"
STACKS = SAMPLED + ("nuscenes-box-layout", "nuscenes-box-layout-v6 glide", "openai_unet glide",
                    "openai_unet transformer")
HDIT_ABSOLUTE = "nuscenes-hdit-uncond spherical_harmonics"  # no JAX forward (ROADMAP Queue 3 item 18)
TRAINED = ("nuscenes-auto-reg-v2", "nuscenes-box-layout", "discrete")
BRANCHES = ("nuscenes-layout", "nuscenes-object")
SAMPLE_LIMIT = 2e-2  # the JAX package's own limit for its sp sample (__graft_entry__.py)
V0_EDITS = dict(model={"num_head_channels": 64})  # 64 channels at ds4: one head, OACA dims 64^3


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_map_equals_jax(sp):
    devices = jax.devices()[:8]
    assert len(devices) == 8
    jmesh = jax_make_mesh(8, sp=sp, devices=devices)
    shape = (4, 32, 128, 2)
    want = jax_batch_sharding(jmesh, 4, sp_axis=2).devices_indices_map(shape)
    for r, device in enumerate(devices):
        mesh = make_mesh(world=8, sp=sp, rank=r)
        got = batch_sharding(mesh, 4, sp_axis=2).slices(shape)
        norm = tuple(slice(*s.indices(n)) for s, n in zip(got, shape))
        assert norm == tuple(slice(*s.indices(n)) for s, n in zip(want[device], shape)), (r, got, want[device])
        assert (mesh.dp_index, mesh.sp_index) == tuple(int(i) for i in np.argwhere(jmesh.devices == device)[0])


# ------------------------------------------------------------------ (b)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cond_forward(pair, x, t) -> np.ndarray:
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    jlayout = jax.jit(pair.jmodels["cond"].apply)(pair.params["cond"], jbatch)
    return np.asarray(jax.jit(pair.jmodels["model"].apply)(
        pair.params["model"], jnp.asarray(x), {"time_condition": jnp.asarray(t), "other_condition": jlayout}))


def _train_batch(jcfg, rnd, with_condition: bool = True):
    """A (4, H, W, 2) x_0 (with a condition batch) and a loss mask whose
    ones thin out along W, so that the shards hold different counts."""
    H, W = jcfg.data.resolution
    x_0 = torch.as_tensor(rnd.uniform(-1, 1, (4, H, W, 2)).astype(np.float32))
    mask = (rnd.uniform(size=(4, H, W, 1)) < np.linspace(0.2, 0.9, W)[None, None, :, None]).astype(np.float32)
    mask = torch.as_tensor(np.broadcast_to(mask, (4, H, W, 2)).copy())
    if not with_condition:
        return x_0, mask
    batch = {k: torch.as_tensor(v) for k, v in condition_batch(jcfg, 4, seed=3).items()}
    return dict(batch, x_0=x_0), mask


def _prepare(out: Path) -> dict:
    """The small stacks with the harness's shared weights, their inputs,
    the JAX forwards; the port's share written to ``out/inputs.pt``."""
    rnd = np.random.RandomState(7)
    t = np.array([-3.0, 5.0], np.float32)
    inputs, jax_out = {}, {}

    def x_like(jcfg):
        H, W = jcfg.data.resolution
        return rnd.standard_normal((2, H, W, 2)).astype(np.float32)

    def uncond_case(name, pair, sampled=False):
        x = x_like(pair.jcfg)
        jax_out[name] = np.asarray(jax.jit(pair.jmodel.apply)(pair.params, jnp.asarray(x), jnp.asarray(t)))
        inputs[name] = {"kind": "uncond", "cfg": pair.tcfg, "state": {"model": pair.tmodel.state_dict()},
                        "x": torch.as_tensor(x), "t": torch.as_tensor(t)}
        if sampled:
            inputs[name]["x_T"] = torch.as_tensor(x_like(pair.jcfg))

    def cond_case(name, pair, sampled=False):
        x = x_like(pair.jcfg)
        jax_out[name] = _jax_cond_forward(pair, x, t)
        inputs[name] = {"kind": "cond", "cfg": pair.tcfg, "state": {k: m.state_dict() for k, m in pair.tmodels.items()},
                        "x": torch.as_tensor(x), "t": torch.as_tensor(t),
                        "batch": {k: torch.as_tensor(v) for k, v in pair.batch.items()}}
        if sampled:
            inputs[name]["x_T"] = torch.as_tensor(x_like(pair.jcfg))
        return inputs[name]

    uncond_case("nuscenes-unet-uncond", UncondPair("nuscenes-unet-uncond"), sampled=True)
    ar = Pair("nuscenes-auto-reg-v2", small=True)
    cond_case("nuscenes-auto-reg-v2", ar, sampled=True)
    inputs["nuscenes-auto-reg-v2"]["train_batch"], inputs["nuscenes-auto-reg-v2"]["loss_mask"] = _train_batch(ar.jcfg, rnd)
    v0 = Pair("nuscenes-box-layout", small=True, cfgs=zoo_cfgs("nuscenes-box-layout", **V0_EDITS))
    cond_case("nuscenes-box-layout", v0)
    inputs["nuscenes-box-layout"]["train_batch"], inputs["nuscenes-box-layout"]["loss_mask"] = _train_batch(v0.jcfg, rnd)
    glide = Pair("nuscenes-box-layout-v6", small=True, cfgs=zoo_cfgs(
        "nuscenes-box-layout-v6", resolution=(16, 64), model=GLIDE, cond={"resolution_to_attention": (2,)}))
    cond_case("nuscenes-box-layout-v6 glide", glide)
    uncond_case("nuscenes-hdit-uncond", UncondZooPair("nuscenes-hdit-uncond"), sampled=True)
    for kind in ("glide", "transformer"):
        net = NetPair(kind)
        jax_out[f"openai_unet {kind}"] = net.want
        inputs[f"openai_unet {kind}"] = {
            "kind": "openai", "kw": net.kw, "state": {"model": net.tmodel.state_dict()},
            "x": torch.as_tensor(net.x), "t": torch.as_tensor(net.t),
            "y": None if net.y is None else torch.as_tensor(net.y, dtype=torch.int64),
            "ctx": None if net.ctx is None else torch.as_tensor(net.ctx)}
    _, tcfg = zoo_cfgs("nuscenes-hdit-uncond", model={"positional_embedding": "spherical_harmonics"})
    inputs[HDIT_ABSOLUTE] = {"kind": "uncond", "cfg": tcfg, "x": torch.as_tensor(x_like(tcfg)),
                             "t": torch.as_tensor(t)}
    flow = UncondPair(FLOW, seed=0)
    x = x_like(flow.jcfg)
    t_flow, r_flow = np.array([0.8, 0.45], np.float32), np.array([0.1, 0.45], np.float32)
    jax_out[FLOW] = np.asarray(jax.jit(flow.jmodel.apply)(flow.params, *map(jnp.asarray, (x, t_flow, r_flow))))
    H, W = flow.jcfg.data.resolution
    train_x = np.clip(0.5 * rnd.standard_normal((4, H, W, 2)), -1, 1).astype(np.float32)
    rng_tr, rng_e = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 0))  # the JAX step's draws
    draws = dict(zip(("t", "r"), flow.jengine.sample_t_r(rng_tr, 4)), noise=jax.random.normal(rng_e, train_x.shape))
    inputs[FLOW] = {"kind": "flow", "cfg": flow.tcfg, "state": {"model": flow.tmodel.state_dict()},
                    "x": torch.as_tensor(x), "t": torch.as_tensor(t_flow), "r": torch.as_tensor(r_flow),
                    "v": torch.as_tensor(x_like(flow.jcfg)), "z": torch.as_tensor(x_like(flow.jcfg)),
                    "train_x": torch.as_tensor(train_x),
                    "draws": {k: torch.as_tensor(np.asarray(v)) for k, v in draws.items()},
                    "cli": ["-c", FLOW, "--synthetic-data", "--device", "cpu", "--resolution", str(H), str(W),
                            "--model-channels", "16", "-b", "2", "--num-steps", "2", "--log-every", "1",
                            "--set", 'training.mixed_precision="no"', "--set", "training.steps_save_image=0"]}
    jcfg, tcfg = zoo_cfgs("nuscenes-unet-uncond", timestep_type="discrete", num_training_steps=100)
    x_0, mask = _train_batch(jcfg, rnd, with_condition=False)
    inputs["discrete"] = {"kind": "uncond", "cfg": tcfg, "train_batch": x_0, "loss_mask": mask}
    for name, small in (("nuscenes-layout", layout_small), ("nuscenes-object", object_small)):
        cfg = small(tcfgs)
        cfg.training.batch_size_train, cfg.training.mixed_precision = 4, "no"
        inputs[name] = {"cfg": cfg}
    inputs.update(stacks=STACKS + (HDIT_ABSOLUTE,), train=TRAINED, branches=BRANCHES, flow=(FLOW,))
    torch.save(inputs, out / "inputs.pt")
    return jax_out, lambda: _jax_flow_step(flow, train_x, out)


def _jax_flow_step(pair, x, out: Path) -> dict:
    """One step of the JAX ``FlowTrainer`` on an 8-virtual-device (4, 2)
    mesh on the pair's weights: its loss and its gradients (read from an
    identity transformation chained before its optimizer)."""
    jcfg = pair.jcfg
    jcfg.training.mixed_precision = "no"
    logs = []
    trainer = JFlowTrainer(jcfg, iter([{"x_0": x}]), mesh=jax_make_mesh(8, sp=2, devices=jax.devices()[:8]),
                           output_dir=str(out / "jax_flow"), log_fn=logs.append)
    trainer.tx = optax.chain(_capture(), trainer.tx)
    trainer.prepare_batch = lambda batch: jnp.asarray(batch["x_0"])
    state = trainer.train(num_steps=1, rng=jax.random.PRNGKey(7), state=JState.create(pair.params, trainer.tx),
                          checkpoint_every=10**9, preview_every=0, log_every=1)
    return {"loss": logs[0]["loss"], "grads": _state_dicts(state.opt_state[0], {"model": pair.tmodel})}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    jax_out, jax_flow_step = _prepare(out)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_port_sp_ranks.py"), str(r), str(WORLD),
                               str(port), str(out)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        jax_out[f"train {FLOW}"] = jax_flow_step()  # while the ranks run
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:  # a rank that failed leaves the others waiting in a collective
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return torch.load(out / "results.pt", weights_only=False), jax_out


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", LAYERS)
def test_layer_on_shards_equals_one_process(ranks, name, sp):
    r = ranks[0]["layers"][f"{name} sp={sp}"]
    assert r["out"] <= 1e-6, r
    assert r["grad_x"] <= 1e-6, r
    assert r["grad_params"] <= 1e-6, r
    if name.endswith(" jvp"):
        assert r["tangent_scale"] > 1e-2, r
        assert r["tangent"] <= 1e-6, r
        assert r["tangent_forward_ad"] <= 1e-6, r


@pytest.mark.parametrize("name", STACKS + (FLOW,))
def test_stack_forward_at_sp2_equals_jax(ranks, name):
    results, jax_out = ranks
    got, want = results[name]["forward"].numpy(), jax_out[name]
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    one = results[name]["forward_one"].numpy()
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-5 * max(1.0, np.abs(one).max()))


def test_hdit_with_an_absolute_embedding_at_sp2_equals_one_process(ranks):
    r = ranks[0][HDIT_ABSOLUTE]
    got, one = r["forward"], r["forward_one"]
    assert got.shape == one.shape and float(one.abs().max()) > 1e-2
    torch.testing.assert_close(got, one, rtol=0, atol=1e-5 * max(1.0, float(one.abs().max())))


@pytest.mark.parametrize("name", SAMPLED)
def test_ddim_sample_on_the_mesh(ranks, name):
    r = ranks[0][name]
    one = r["sample_one"]
    assert torch.isfinite(r["sample"]).all() and r["sample"].shape == one.shape
    assert torch.equal(r["sample_whole_stats"], one)
    assert float((r["sample"] - one).abs().max()) <= SAMPLE_LIMIT


def test_hdit_sample_on_the_mesh_is_the_one_process_sample_bit_for_bit(ranks):
    """HDiT merges no statistics across the ranks: its halos and gathers
    move values, so on the CPU its sample on the sp ranks (the whole batch
    on each, as one process has it) is one process's, bit for bit."""
    r = ranks[0]["nuscenes-hdit-uncond"]
    assert torch.equal(r["sample"], r["sample_one"])


def test_train_step_on_a_dp2_sp2_mesh_equals_one_process(ranks):
    r = ranks[0]["train nuscenes-auto-reg-v2"]
    assert len(set(r["mask_counts"])) == len(r["mask_counts"])  # the shards' masks differ
    assert abs(r["loss"] - r["loss_one"]) <= 1e-5 * max(1.0, abs(r["loss_one"]))
    assert r["grad_rel_l2"] <= 1e-4


@pytest.mark.parametrize("name", ["nuscenes-box-layout", "discrete"])
def test_v0_step_and_discrete_loss_on_a_dp2_sp2_mesh_equal_one_process(ranks, name):
    r = ranks[0][f"train {name}"]
    assert len(set(r["mask_counts"])) == len(r["mask_counts"])
    assert abs(r["loss"] - r["loss_one"]) <= 1e-5 * max(1.0, abs(r["loss_one"]))
    assert r["grad_rel_l2"] <= 1e-4


@pytest.mark.parametrize("name", BRANCHES)
def test_branch_step_replicated_over_sp_equals_one_process(ranks, name):
    r = ranks[0][f"branch {name}"]
    assert r["mesh"] == (2, 2) and not r["sharded"]
    assert abs(r["loss"] - r["loss_one"]) <= 1e-5 * max(1.0, abs(r["loss_one"]))
    assert r["grad_rel_l2"] <= 1e-4


def test_meanflow_tangent_on_a_dp2_sp2_mesh_equals_one_process(ranks):
    """du/dt along (v, 1, 0), the MeanFlow loss's jvp, under
    ``torch.func.jvp`` and as a ``forward_ad`` dual."""
    r = ranks[0][FLOW]
    one = r["tangent_one"]
    scale = max(1.0, float(one.abs().max()))
    for key in ("tangent", "tangent_forward_ad"):
        assert r[key].shape == one.shape
        torch.testing.assert_close(r[key], one, rtol=0, atol=1e-5 * scale)


def test_meanflow_call_exchanges_under_a_tangent(ranks):
    """A tangent under ``torch.func.jvp`` costs at most a second exchange
    for each of the call's; a ``forward_ad`` dual's travels with its
    primal."""
    n = ranks[0][FLOW]["exchanges"]
    assert n["no tangent"] > 0, n
    assert n["torch.func.jvp"] <= 2 * n["no tangent"], n
    assert n["forward_ad"] == n["no tangent"], n


def test_meanflow_one_step_sample_on_the_mesh(ranks):
    r = ranks[0][FLOW]
    one = r["sample_one"]
    assert torch.isfinite(r["sample"]).all() and r["sample"].shape == one.shape
    assert torch.equal(r["sample_whole_stats"], one)
    torch.testing.assert_close(r["sample"], one, rtol=0, atol=1e-5 * max(1.0, float(one.abs().max())))


def test_meanflow_step_on_a_dp2_sp2_mesh_equals_one_process_and_jax(ranks):
    results, jax_out = ranks
    r, j = results[f"train {FLOW}"], jax_out[f"train {FLOW}"]
    assert abs(r["loss"] - r["loss_one"]) <= 1e-5 * max(1.0, abs(r["loss_one"]))
    flat, flat_one = (torch.cat([g.flatten() for g in gs.values()]) for gs in (r["grads"], r["grads_one"]))
    assert float((flat - flat_one).norm() / flat_one.norm()) <= 1e-4
    assert r["loss"] == pytest.approx(j["loss"], rel=1e-5)
    _assert_grads(r["grads"], j["grads"])


def test_train_cli_meanflow_at_sp2_logs_the_one_process_losses(ranks):
    r = ranks[0][f"cli {FLOW}"]
    assert r["mesh"] == (2, 2) and len(r["losses"]) == len(r["losses_one"]) == 2, r
    for a, b in zip(r["losses"], r["losses_one"]):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), r


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("shards,affine", [(2, True), (4, False)])
def test_group_norm_split_equals_plain(shards, affine):
    gen = torch.Generator().manual_seed(0)
    B, H, W, C, G = 2, 4, 32, 64, 8
    x = torch.randn(B, H, W, C, generator=gen) * 3 + 1
    w, b = (torch.randn(C, generator=gen), torch.randn(C, generator=gen)) if affine else (None, None)
    s, t = torch.randn(B, C, generator=gen), torch.randn(B, C, generator=gen)
    want = group_norm_plain(x, w, b, num_groups=G, eps=1e-6, scale=s, shift=t, silu=True)
    pieces = x.chunk(shards, dim=2)
    parts = torch.stack([group_norm_partials_plain(p, G) for p in pieces])
    assert parts.shape == (shards, B, 3, G)
    got = torch.cat([group_norm_apply_plain(p, parts, w, b, num_groups=G, eps=1e-6, scale=s, shift=t, silu=True)
                     for p in pieces], dim=2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def _split_tangent_case(shards: int, affine: bool, mean: float, std: float):
    """x (2, 4, 32, 64) in 8 groups, its affine operands and tangents for
    all of them, float32; ``shards`` column shards."""
    gen = torch.Generator().manual_seed(shards)
    B, H, W, C = 2, 4, 32, 64
    x = torch.randn(B, H, W, C, generator=gen) * std + mean
    w, b = (torch.randn(C, generator=gen), torch.randn(C, generator=gen)) if affine else (None, None)
    s, t = torch.randn(B, C, generator=gen) * 0.3, torch.randn(B, C, generator=gen)
    primals = (x, w, b, s, t)
    tangents = tuple(None if a is None else torch.randn(a.shape, generator=gen) for a in primals)
    return primals, tangents


def _split_rules(primals, tangents, shards: int, G: int = 8):
    """The tangent of the split norm by the card Functions' rules: every
    shard's partials and their tangents, stacked as the exchange gathers
    them, then each shard's apply tangent."""
    x, dx = primals[0], tangents[0]
    pieces, dpieces = x.chunk(shards, dim=2), dx.chunk(shards, dim=2)
    parts = torch.stack([group_norm_partials_plain(p, G) for p in pieces])
    dparts = torch.stack([group_norm_partials_jvp(p, d, G) for p, d in zip(pieces, dpieces)])
    return torch.cat([group_norm_apply_jvp((p, parts, *primals[1:]), (d, dparts, *tangents[1:]), num_groups=G,
                                           eps=1e-6, silu=True) for p, d in zip(pieces, dpieces)], dim=2)


@pytest.mark.parametrize("shards,affine", [(2, True), (4, False)])
def test_group_norm_split_tangent_equals_group_norm_jvp(shards, affine):
    primals, tangents = _split_tangent_case(shards, affine, 1.0, 3.0)
    want = group_norm_jvp(primals, tangents, num_groups=8, eps=1e-6, silu=True)
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(_split_rules(primals, tangents, shards), want, rtol=0, atol=tol)
    given = [i for i, a in enumerate(primals) if a is not None]

    def split(*ops):
        full = list(primals)
        for i, a in zip(given, ops):
            full[i] = a
        x, w, b, s, t = full
        pieces = x.chunk(shards, dim=2)
        parts = torch.stack([group_norm_partials_plain(p, 8) for p in pieces])
        return torch.cat([group_norm_apply_plain(p, parts, w, b, num_groups=8, eps=1e-6, scale=s, shift=t, silu=True)
                          for p in pieces], dim=2)

    _, auto = torch.func.jvp(split, tuple(primals[i] for i in given), tuple(tangents[i] for i in given))
    torch.testing.assert_close(auto, want, rtol=0, atol=tol)


def test_group_norm_split_tangent_is_stable_where_the_mean_dwarfs_sigma():
    """A mean of 300 σ: the rules sum over each shard's own deviations from
    its mean, so the split tangent stays as close to a float64 tangent as
    one process's ``group_norm_jvp`` is."""
    primals, tangents = _split_tangent_case(4, True, 900.0, 3.0)
    B, H, W, C = primals[0].shape

    def ref(x, w, b, s, t):
        y = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2).contiguous(), 8, eps=1e-6).permute(0, 2, 3, 1)
        return torch.nn.functional.silu(y * (w * (1 + s))[:, None, None] + (b * (1 + s) + t)[:, None, None])

    _, want = torch.func.jvp(ref, tuple(a.double() for a in primals), tuple(a.double() for a in tangents))
    err_split = float((_split_rules(primals, tangents, 4).double() - want).abs().max())
    err_one = float((group_norm_jvp(primals, tangents, num_groups=8, eps=1e-6, silu=True).double() - want).abs().max())
    assert err_split <= max(2.0 * err_one, 1e-6 * float(want.abs().max())), (err_split, err_one)


@pytest.mark.parametrize("sp,d", [(2, 32), (4, 32), (2, 64)])
def test_oaca_plain_with_gathered_keys_equals_jax(sp, d):
    rnd = np.random.RandomState(sp)
    B, nh, h, W, L2 = 2, 2, 4, 32, 13
    L = h * W

    def r(*shape):
        return rnd.standard_normal(shape).astype(np.float32)

    q_c, ipe, k_c, v_c = r(B, nh, L, d), r(B, nh, L, d), r(B, nh, L, d), r(B, nh, L, d)
    k_l, v_l = r(B, nh, L2, 2 * d), r(B, nh, L2, d)
    scale = 1.0 / np.sqrt(np.sqrt(2 * d))
    want = np.asarray(_oaca_unfused(*map(jnp.asarray, (q_c, ipe, k_c, k_l, v_c, v_l)), scale))
    T = torch.as_tensor
    cols = W // sp
    for j in range(sp):  # rank j's queries: its columns of every row of the (h, W) token map
        rows = (np.arange(h)[:, None] * W + j * cols + np.arange(cols)[None, :]).reshape(-1)
        got = oaca_attention_plain(T(q_c[:, :, rows]), T(ipe[:, :, rows]), T(k_c), T(k_l), T(v_c), T(v_l),
                                   scale=scale, ipe_k=T(ipe)).numpy()
        np.testing.assert_allclose(got, want[:, :, rows], rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------------ (d)


VARIANTS = {  # registry configs with a model or engine option set
    "nuscenes-box-layout-v6 glide": ("nuscenes-box-layout-v6", "--set", 'model.params.attention_block_type="GLIDE"'),
    "openai_unet": ("nuscenes-unet-uncond", "--set", 'model.architecture="openai_unet"'),
    "discrete": ("nuscenes-unet-uncond", "--set", 'diffusion.timestep_type="discrete"',
                 "--set", "diffusion.num_training_steps=1000"),
}
ACCEPTED = sorted(tcfgs.__all__) + sorted(VARIANTS)
REFUSED = {  # denoisers outside train.SP_ARCHITECTURES, set on an image config
    "refinenet": ("nuscenes-unet-uncond", "--set", 'model.architecture="refinenet"'),
    "easy_unet": ("nuscenes-unet-uncond", "--set", 'model.architecture="easy_unet"'),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_train_cli_refuses_what_is_not_sp_aware(case):
    name, *extra = REFUSED[case]
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-c", name, "--device", "cpu", "--sp", "2", *extra])
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(["-c", name, "--sp", "2", *extra]))
    said = str(e.value)
    assert "not sp-aware" in said and cfg.model.architecture == case and case in said, said


@pytest.mark.parametrize("case", ACCEPTED)
def test_train_cli_takes_every_sp_aware_config(case):
    """``check_sp`` passes at --sp 2, and the CLI then stops only because
    no torchrun group is there to split the azimuth over."""
    name, *extra = VARIANTS.get(case, (case,))
    args = train_cli.build_parser().parse_args(["-c", name, "--sp", "2", *extra])
    cfg = train_cli.config_from_args(args)
    train_cli.check_sp(cfg, 2)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-c", name, "--device", "cpu", "--sp", "2", *extra])
    assert "torchrun" in str(e.value), str(e.value)


@pytest.mark.parametrize("sp,resolution", [(16, "128"), (3, "1024")])
def test_train_cli_refuses_widths_that_do_not_split_evenly(sp, resolution):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-c", "nuscenes-unet-uncond", "--device", "cpu", "--resolution", "32", resolution,
                        "--sp", str(sp)])
    assert "even down to the deepest" in str(e.value), str(e.value)


def test_train_cli_refuses_hdit_shards_narrower_than_the_halo():
    """W / sp = 32 keeps HDiT's shards even to the global level, but leaves
    2 token columns a rank at the deepest local level, less than the 3×9
    window's halo of 4."""
    train_cli.check_sp(train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["-c", "nuscenes-hdit-uncond"])), 16)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-c", "nuscenes-hdit-uncond", "--device", "cpu", "--sp", "32"])
    assert "even down to the deepest" in str(e.value) and "halo of 4" in str(e.value), str(e.value)


def test_train_cli_sp_needs_torchrun():
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-c", "nuscenes-unet-uncond", "--device", "cpu", "--resolution", "32", "128", "--sp", "2",
                        "--synthetic-data"])
    assert "torchrun" in str(e.value)


def test_rank_windows_cut_the_global_draw():
    """``draws.Rows`` with a ``Columns`` window: the (dp, sp) ranks' cuts of
    a draw tile the one-process draw, and a per-row draw is whole."""
    def gen():
        return torch.Generator().manual_seed(9)

    whole = torch.randn((4, 3, 16, 2), generator=gen())
    rows = [[batch_sharding(make_mesh(world=4, sp=2, rank=2 * d + s), 4, sp_axis=2).rows(4, 16) for s in (0, 1)]
            for d in (0, 1)]
    got = torch.cat([torch.cat([r.randn(gen(), "cpu", (3, 8, 2)) for r in row], dim=2) for row in rows])
    assert torch.equal(got, whole)
    assert torch.equal(rows[1][1].rand(gen(), "cpu"), torch.rand(4, generator=gen())[2:])
