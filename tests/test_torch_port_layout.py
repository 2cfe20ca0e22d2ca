"""The scene graph → 4D layout branch of the PyTorch port against the JAX
package, on the CPU, at small width: ``nuscenes-layout`` with
``model_channels`` 128 and ``crossattn_dim`` / ``concat_dim`` 128 (the
scene-graph GCNs at their published widths: the box GCN's node input is
built from the 512-d CLIP slot and the 64-d embeddings), 2 scenes × (ego + 4
objects) from ``utils/synthetic.py`` (real pairwise triples; the second
scene's last object has none).  Weights are numpy-seeded for every flax
``params`` leaf and every ``batch_stats`` leaf and go to the port through
its weight bridge.

Why 128 channels and not 64: the UNet's 32-group norms see one token, so at
64 channels a group holds 2 values, which it maps to ±1 whatever their
distance; where the two lie within rounding of each other, a last-bit
difference between the frameworks flips the pair (0.49 of the largest
output, seen).  At 128 a group holds 4 values (the published width: 16 and
32) and the packages agree to ~5e-6.

Limits (``PERF.md`` §2): modules 1e-5 and UNets 1e-4 of max(1, the largest
output), samplers and losses 1e-4 relative (L2 for arrays); the host
functions exactly.  The GCN's segment sums add in another order than
``jax.ops.segment_sum``; that stays far inside 1e-5.
"""

import copy
import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.datasets import scene_graph as JSG
from lidarcrafter_tpu.datasets import transforms as JT
from lidarcrafter_tpu.models.graph import GraphTripleConvNet as JGCN
from lidarcrafter_tpu.training.factory import build_layout_training as jax_build
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import generate_layout
from lidarcrafter_tpu_torch.datasets import scene_graph as TSG
from lidarcrafter_tpu_torch.datasets import transforms as TT
from lidarcrafter_tpu_torch.kernels import groupnorm
from lidarcrafter_tpu_torch.models import build_model
from lidarcrafter_tpu_torch.models.graph import GraphTripleConvNet
from lidarcrafter_tpu_torch.models.ops import GroupNorm32
from lidarcrafter_tpu_torch.training.factory import build_layout_training as torch_build
from lidarcrafter_tpu_torch.utils.synthetic import synthetic_scene_graphs
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, init_random_, load_flax_params

SCENES, OBJECTS = 2, 4
MODEL_CHANNELS, CONTEXT = 128, 128
MODULE_TOL, UNET_TOL, SAMPLER_L2 = 1e-5, 1e-4, 1e-4
STEPS = 5


def small(configs):
    """Three levels of one residual block (down, up, skip concats and the
    transformers at ds 2 and 4 all still run), two layers in each
    scene-graph GCN (the box GCN keeps its five)."""
    cfg = configs.apply_reduced_topology(configs.get_config("nuscenes-layout"), model_channels=MODEL_CHANNELS)
    cfg.model.params.update(crossattn_dim=CONTEXT, concat_dim=CONTEXT, channel_mult=(1, 1, 1), num_res_blocks=1)
    cfg.condition_model.params["gconv_num_layers"] = 2
    return cfg


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class Stack:
    """``nuscenes-layout`` built by both packages (at ``configure``'s
    topology) with shared random weights and one collated request."""

    def __init__(self, configure=small):
        self.jmodels, jengine, _ = jax_build(configure(jcfgs))
        # each network compiled once, shared by the forward, the loss and the step
        self.jengine = dataclasses.replace(jengine, apply_fn=jax.jit(jengine.apply_fn),
                                           cond_apply_fn=jax.jit(jengine.cond_apply_fn))
        self.tmodels, self.tengine, _ = torch_build(configure(tcfgs), device="cpu")
        self.batch = synthetic_scene_graphs(SCENES, OBJECTS, seed=3)
        dec = self.batch["decoder"]
        self.N, self.T = len(dec["objs"]), len(dec["tripltes"])
        self.jsg = {"objs": jnp.asarray(dec["objs"]), "triples": jnp.asarray(dec["tripltes"]),
                    "text_feats": jnp.asarray(dec["text_feats"]), "rel_feats": jnp.asarray(dec["rel_feats"])}
        self.jinput = {"boxes": jnp.asarray(dec["boxes"]), "scene_ids": jnp.asarray(dec["obj_to_scene"]),
                       "scenegraph": self.jsg}
        self.tinput = generate_layout.layout_request(self.batch, "cpu")
        sg = self.jsg
        cond_shapes = jax.eval_shape(self.jmodels["cond"].init, jax.random.PRNGKey(0), sg["objs"], sg["triples"],
                                     sg["text_feats"], sg["rel_feats"])
        cond = random_params(cond_shapes, 1)
        _, obj_embed = jax.eval_shape(self.jmodels["cond"].apply, cond, sg["objs"], sg["triples"],
                                      sg["text_feats"], sg["rel_feats"])
        cd = {"time_condition": jnp.zeros((self.N,)), "other_condition": {"preds": sg["triples"], "uc_b": obj_embed}}
        model_shapes = jax.eval_shape(self.jmodels["model"].init, jax.random.PRNGKey(0),
                                      jnp.zeros((self.N, 20)), cd)
        self.params = {"model": random_params(model_shapes, 2), "cond": cond}
        for k in ("model", "cond"):
            assert set(self.params[k]) == {"params", "batch_stats"}
            load_flax_params(self.tmodels[k], self.params[k])


@pytest.fixture(scope="module")
def stack():
    return Stack()


def test_graph_triple_conv_net_with_masked_triples_matches_jax():
    """Running statistics (serving) and the batch-statistics path with its
    running-average update (training), masked triples and a node without
    messages, residual projections."""
    rnd = np.random.RandomState(0)
    N, T, Do, Dp = 9, 24, 24, 16
    obj = rnd.standard_normal((N, Do)).astype(np.float32)
    pred = rnd.standard_normal((T, Dp)).astype(np.float32)
    edges = rnd.randint(0, N - 1, (T, 2))  # node N - 1 has no triple
    mask = rnd.uniform(size=T) > 0.3
    kw = dict(input_dim_obj=Do, input_dim_pred=Dp, num_layers=3, hidden_dim=32, residual=True,
              mlp_normalization="batch", output_dim=20)
    jmod = JGCN(**kw)
    args = [jnp.asarray(a) for a in (obj, pred, edges, mask)]
    variables = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args), 4)
    tmod = load_flax_params(GraphTripleConvNet(**kw), variables)
    targs = [torch.as_tensor(a) for a in (obj, pred, edges, mask)]
    with torch.no_grad():
        for got, want in zip(tmod(*targs), jax.jit(jmod.apply)(variables, *args)):
            close(got, want, MODULE_TOL)
        (jo, jp), updated = jax.jit(functools.partial(jmod.apply, use_running_average=False,
                                                      mutable=["batch_stats"]))(variables, *args)
        to, tp = tmod(*targs, use_running_average=False)
    close(to, jo, MODULE_TOL)
    close(tp, jp, MODULE_TOL)
    want_stats = flax_to_state_dict({"params": variables["params"], "batch_stats": updated["batch_stats"]}, tmod)
    stats = [k for k in want_stats if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 4 * 3  # two BNs in each MLP, two MLPs a layer
    for k in stats:
        close(tmod.state_dict()[k], want_stats[k], MODULE_TOL)
        assert not torch.equal(want_stats[k], flax_to_state_dict(variables, tmod)[k])  # the update moved them


@pytest.mark.parametrize("edits", [False, True])
def test_scene_graph_matches_jax(stack, edits):
    """Both GCNs; with edits: added and manipulated nodes, masked triples
    and the JAX change noise injected."""
    sg, N = dict(stack.jsg), stack.N
    rnd = np.random.RandomState(5)
    kw, tkw = {}, {}
    if edits:
        masks = {"added_mask": np.arange(N) == 2, "manipulated_mask": np.isin(np.arange(N), [4, 7]),
                 "edge_mask": rnd.uniform(size=stack.T) > 0.2}
        rng = jax.random.PRNGKey(9)
        kw = {k: jnp.asarray(v) for k, v in masks.items()} | {"rng": rng}
        tkw = {k: torch.as_tensor(v) for k, v in masks.items()}
        tkw["noise"] = torch.as_tensor(np.asarray(jax.random.normal(rng, (N, 64), jnp.float32)))
    want = jax.jit(stack.jmodels["cond"].apply)(stack.params["cond"], sg["objs"], sg["triples"],
                                                sg["text_feats"], sg["rel_feats"], **kw)
    ts = stack.tinput["scenegraph"]
    with torch.no_grad():
        got = stack.tmodels["cond"](ts["objs"], ts["triples"], ts["text_feats"], ts["rel_feats"], **tkw)
    for g, w in zip(got, want):
        close(g, w, MODULE_TOL)
    if edits:  # the edits matter
        plain = stack.tmodels["cond"](ts["objs"], ts["triples"], ts["text_feats"], ts["rel_feats"])
        assert float((plain[0] - got[0]).abs().max()) > 1e-2


def _condition(stack):
    """The scene-graph condition of the request, for both packages."""
    jcond = stack.jengine.get_network_condition(stack.params, None, stack.jinput, only_custom=True)
    with torch.no_grad():
        tcond = stack.tengine.get_network_condition(stack.tinput)
    return jcond["other_condition"], tcond


def test_unet1d_matches_jax(stack):
    rnd = np.random.RandomState(6)
    box = rnd.standard_normal((stack.N, 20)).astype(np.float32)
    log_snr = rnd.uniform(-6, 6, stack.N).astype(np.float32)
    jother, tcond = _condition(stack)
    want = stack.jengine.apply_fn(stack.params, jnp.asarray(box),
                                  {"time_condition": jnp.asarray(log_snr), "other_condition": jother})
    with torch.no_grad():
        got = stack.tmodels["model"](torch.as_tensor(box), dict(tcond, time_condition=torch.as_tensor(log_snr)))
    assert float(np.abs(want).max()) > 0.1
    close(got, want, UNET_TOL)


def test_layout_loss_matches_jax(stack):
    """``loss`` at the JAX key chain's per-scene t and noise."""
    key = jax.random.PRNGKey(11)
    want = float(stack.jengine.loss(stack.params, key, stack.jinput, num_scenes=SCENES))
    rng_t, rng_q = jax.random.split(key)
    t_scene = jax.random.uniform(rng_t, (SCENES,), dtype=jnp.float32)
    noise = jax.random.normal(jax.random.split(rng_q)[0], (stack.N, 20), jnp.float32)
    with torch.no_grad():
        got = float(stack.tengine.loss(stack.tinput, SCENES, t_scene=torch.as_tensor(np.asarray(t_scene)),
                                       noise=torch.as_tensor(np.asarray(noise))))
    assert got == pytest.approx(want, rel=1e-4)
    # the mask holds: the ego's box columns do not count
    assert float(stack.tinput["boxes"][0, 20:28].sum()) == 0


def test_ddim_sample_with_the_jax_x_T_matches_jax(stack):
    key = jax.random.PRNGKey(3)
    want = np.asarray(stack.jengine.sample(stack.params, key, stack.jinput, num_steps=STEPS, mode="ddim"))
    x_T = jax.random.normal(jax.random.split(key, 3)[0], (stack.N, 20), jnp.float32)
    got = stack.tengine.sample(stack.tinput, STEPS, mode="ddim", x_T=torch.as_tensor(np.asarray(x_T))).numpy()
    assert got.shape == want.shape == (stack.N, 20) and np.isfinite(got).all()
    assert rel_l2(got, want) <= SAMPLER_L2
    other = stack.tengine.sample(stack.tinput, STEPS, mode="ddim", x_T=torch.as_tensor(np.asarray(x_T)) * 0.5)
    assert rel_l2(other, want) > 100 * SAMPLER_L2
    with pytest.raises(ValueError, match="ddpm or ddim"):
        stack.tengine.sample(stack.tinput, STEPS, mode="dpmpp_2m")


def test_teacher_forced_ddpm_step_matches_jax(stack):
    """One DDPM step t=0.6 → s=0.4 from the same x_t with the JAX step's
    noise."""
    rnd = np.random.RandomState(8)
    x_t = rnd.standard_normal((stack.N, 20)).astype(np.float32)
    t, s = np.full(stack.N, 0.6, np.float32), np.full(stack.N, 0.4, np.float32)
    rng = jax.random.PRNGKey(12)
    jother, tcond = _condition(stack)
    want = stack.jengine.p_step_cond(stack.params, rng, jnp.asarray(x_t), {"other_condition": jother},
                                     jnp.asarray(t), jnp.asarray(s), mode="ddpm")
    noise = torch.as_tensor(np.asarray(jax.random.normal(rng, x_t.shape, jnp.float32)))
    with torch.no_grad():
        got = stack.tengine.p_step_cond(torch.as_tensor(x_t), tcond, torch.as_tensor(t), torch.as_tensor(s),
                                        mode="ddpm", noise=noise)
    assert rel_l2(got, want) <= SAMPLER_L2


def test_weight_bridge_carries_batch_stats(stack):
    """The running statistics come through the bridge, their absence
    raises, and ``init_random_`` fills them from its seed."""
    model = stack.tmodels["model"]
    params = stack.params["model"]
    sd = flax_to_state_dict(params, model)
    np.testing.assert_array_equal(sd["box_graph_cov.gconv0.net1.bn0.running_mean"].numpy(),
                                  np.asarray(params["batch_stats"]["box_graph_cov"]["gconv0"]["net1"]["bn0"]["mean"]))
    assert "num_batches_tracked" not in " ".join(sd)
    with pytest.raises(KeyError, match="running_var"):
        flax_to_state_dict({"params": params["params"]}, model)
    fresh = init_random_(copy.deepcopy(stack.tmodels["cond"]), 0)
    again = init_random_(copy.deepcopy(stack.tmodels["cond"]), 0)
    var = [b for n, b in fresh.named_buffers() if n.endswith("running_var")]
    assert len(var) == 2 * 2 * 2 * 2  # GCNs × layers × MLPs × BNs
    assert all(bool((v > 1).all()) for v in var)
    for (n, a), b in zip(fresh.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
    key = "gconv_net_ec.gconv0.net1.bn0.running_mean"
    assert not torch.equal(fresh.state_dict()[key], init_random_(copy.deepcopy(fresh), 1).state_dict()[key])


def test_box_relationships_and_collation_match_jax_exactly():
    rnd = np.random.RandomState(2)
    for _ in range(50):
        a, b = rnd.uniform(-20, 20, 7), rnd.uniform(-20, 20, 7)
        a[3:6], b[3:6] = np.abs(a[3:6]), np.abs(b[3:6])
        for ego in (False, True):
            assert TSG.cal_box_relationships(a, b, ego) == JSG.cal_box_relationships(a, b, ego)
    assert (TSG.KEEP_NAMES, TSG.RELATIONSHIPS, TSG.CLASSES) == (JSG.KEEP_NAMES, JSG.RELATIONSHIPS, JSG.CLASSES)

    def graph(n, seed):
        r = np.random.RandomState(seed)
        packing = (r.standard_normal((n, 8)), r.standard_normal((n, 6, 2)), r.uniform(size=(n, 6)) > 0.3)
        boxes = TSG.pack_boxes_with_trajs(*packing)
        np.testing.assert_array_equal(boxes, JSG.pack_boxes_with_trajs(*packing))
        triples = [[int(s), int(r.randint(9)), int(o)] for s, o in r.randint(0, n, (3 * n, 2))]
        return {"objs": list(r.randint(0, 9, n)), "triples": triples, "boxes": list(boxes),
                "words": [f"w{i}" for i in range(len(triples))], "text_feats": list(r.standard_normal((n, 512))),
                "rel_feats": list(r.standard_normal((len(triples), 512)))}

    items = []
    for i, man in enumerate([{"type": "none"}, {"type": "addition", "added_node_id": 2},
                             {"type": "relationship", "original_relship": (1, (3, 4, 0))}]):
        enc = graph(4 + i, i)
        if man["type"] == "relationship":
            enc["changed_id"] = 1
        items.append({"encoder": enc, "decoder": graph(5 + i, 10 + i), "manipulate": man})

    def encode(words):
        return np.full((len(words), 512), float(len(words[0])))

    for fn in (None, encode):
        got = TSG.collate_scene_graphs(copy.deepcopy(items), fn)
        want = JSG.collate_scene_graphs(copy.deepcopy(items), fn)
        assert set(got) == set(want)
        for k in ("missing_nodes", "manipulated_subs", "manipulated_objs"):
            assert got[k] == want[k]
        for side in ("encoder", "decoder"):
            assert set(got[side]) == set(want[side])
            for k, v in want[side].items():
                assert got[side][k].dtype == v.dtype
                np.testing.assert_array_equal(got[side][k], v)


def test_box_codecs_match_jax_exactly():
    rnd = np.random.RandomState(4)
    boxes = np.concatenate([rnd.uniform(-60, 60, (7, 3)), rnd.uniform(0.5, 8, (7, 3)),
                            rnd.uniform(-3, 3, (7, 1)), rnd.standard_normal((7, 2))], axis=1)
    np.testing.assert_array_equal(TT.scale_boxes_3d(boxes), JT.scale_boxes_3d(boxes))
    np.testing.assert_array_equal(TT.scale_boxes_3d(boxes[:, :7]), JT.scale_boxes_3d(boxes[:, :7]))
    flat = np.concatenate([TT.scale_boxes_3d(boxes[:, :7]), rnd.standard_normal((7, 12))], axis=1)
    for got, want in zip(TT.unscale_boxes_3d(flat), JT.unscale_boxes_3d(flat)):
        np.testing.assert_array_equal(got, want)
    # only the first row of the flat batch is zeroed, as in the JAX tool
    got, _ = TT.unscale_boxes_3d(flat)
    assert (got[0] == 0).all() and np.allclose(got[1:, :6], boxes[1:, :6])


def test_synthetic_scene_graphs_have_real_triples_and_an_unrelated_node():
    batch = synthetic_scene_graphs(3, 5, seed=1)
    dec = batch["decoder"]
    assert len(dec["objs"]) == 18 and dec["boxes"].shape == (18, 40)
    assert dec["text_feats"].shape == (18, 512) and dec["rel_feats"].shape == (len(dec["tripltes"]), 512)
    counts = np.bincount(dec["tripltes"][:, [0, 2]].ravel(), minlength=18)
    assert (counts == 0).sum() == 1 and counts[11] == 0  # scene 1's last object
    per_scene = np.bincount(dec["triple_to_scene"])
    assert per_scene[0] >= 4 * 10 + 3 * 5  # each of 10 pairs ≥ 4 rules, each object ≥ 3 to the ego
    assert np.array_equal(batch["encoder"]["tripltes"], dec["tripltes"])
    again = synthetic_scene_graphs(3, 5, seed=1)["decoder"]
    assert all(np.array_equal(again[k], v) for k, v in dec.items())


def test_group_norm_plan_at_the_token_shapes():
    """The launch the kernel gets for the UNet's (N, 1, C) norms: one block
    an image, one row a pass."""
    for C, threads in ((512, 128), (1024, 256)):
        p = groupnorm.plan(104, 1, C, 32, 4, 132)
        assert (p.k, p.rows_par, p.threads, p.stage_rows) == (1, 1, threads, 1)
    with torch.device("meta"):  # the published width, without its weights
        model = build_model("unet_1d", **tcfgs.get_config("nuscenes-layout").model.params)
    norms = [m for m in model.modules() if isinstance(m, GroupNorm32)]
    assert len(norms) == 56
    assert sorted({(m.weight.numel(), m.eps) for m in norms}) == [(512, 1e-6), (512, 1e-5), (1024, 1e-5)]


def test_generator_raises_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = small(tcfgs)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_layout.LayoutGenerator(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_layout.main(["--synthetic", "1", "--model-channels", "64"])
    assert generate_layout.LayoutGenerator(cfg, device="cpu").device.type == "cpu"


def test_cli_writes_the_jax_tools_pickle(tmp_path):
    graphs = tmp_path / "graphs.pkl"
    with open(graphs, "wb") as f:
        pickle.dump(synthetic_scene_graphs(2, 3, seed=0), f)
    for source in (["--synthetic", "2", "--objects", "3"], ["--graphs", str(graphs)]):
        out = tmp_path / "layout.pkl"
        generate_layout.main([*source, "--num-steps", "2", "--mode", "ddim", "--model-channels", "64",
                              "--device", "cpu", "-o", str(out)])
        with open(out, "rb") as f:
            res = pickle.load(f)
        assert set(res) == {"boxes", "trajs", "raw"}
        assert res["raw"].shape == (8, 20) and res["boxes"].shape == (8, 7) and res["trajs"].shape == (8, 6, 2)
        assert np.isfinite(res["raw"]).all() and (res["boxes"][0] == 0).all()
        np.testing.assert_array_equal(res["trajs"], res["raw"][:, 8:].reshape(8, 6, 2))
    # --ckpt reads a train.py checkpoint (test_torch_port_branch_train.py serves one)
    with pytest.raises(FileNotFoundError):
        generate_layout.main(["--synthetic", "1", "--ckpt", str(tmp_path / "no_such_ckpt"), "--model-channels", "64",
                              "--device", "cpu"])
