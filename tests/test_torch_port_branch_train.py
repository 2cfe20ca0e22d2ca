"""Training the layout and object branches in the PyTorch port against the
JAX package, on the CPU.

(a) ``pad_layout_batch`` equals the JAX one exactly (values and dtypes),
    the default budgets are the JAX trainer's (``_round8(B·14)`` nodes,
    ``_round8(B·442)`` edges) and an oversized batch grows them, logged;
    the EMA and bf16 AMP take the running statistics with the parameters.
(b) One ``LayoutTrainer`` step of the ``nuscenes-layout`` stack of
    ``test_torch_port_layout.py`` at one UNet level (2 scenes, 10 real
    nodes padded to 16, 57 real triples to 64) and one ``ObjectTrainer`` step of the
    ``nuscenes-object`` stack of ``test_torch_port_object.py`` (6 objects of
    64 points from ``synthetic_object_points``) against the JAX
    ``make_train_step`` with shared weights (running statistics included)
    and the JAX key chain's draws injected; the JAX step's gradients read
    from an identity transformation chained before its optimizer.  Loss to
    1e-5 relative, gradients to 1e-4 relative L2 per tensor and 1e-5
    overall (``test_torch_port_train._assert_grads``).  The GCNs' running
    statistics take gradients as the JAX trainer's ``batch_stats`` do (the
    box GCN's; the ``SceneGraph`` GCNs' latent ``c_b`` is not read by
    ``UNet1DModel``, so none of their tensors takes a gradient in either
    package), and the layout loss is a mean over the padded budget: the
    same nodes padded to twice the budget give half the loss.
(c) The ``train`` CLI for 2 steps of ``nuscenes-layout`` and
    ``nuscenes-object`` on the CPU, each checkpoint served through its
    generator's ``--ckpt`` (EMA weights and running statistics bit for bit).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_layout import SCENES
from test_torch_port_layout import Stack as LayoutStack
from test_torch_port_layout import small as layout_small
from test_torch_port_object import POINTS
from test_torch_port_object import Stack as ObjectStack
from test_torch_port_object import small as object_small
from test_torch_port_train import _assert_grads, _capture, _state_dicts, jax_draws
from torch_port_harness import one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.training.loop import pad_layout_batch as j_pad_layout_batch
from lidarcrafter_tpu.training.optim import make_optimizer as j_make_optimizer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu.training.train_step import make_train_step as j_make_train_step
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import generate_layout, generate_object
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.models.graph import MaskedBatchNorm
from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint
from lidarcrafter_tpu_torch.training.loop import LayoutTrainer, ObjectTrainer, pad_layout_batch
from lidarcrafter_tpu_torch.training.optim import AdamW
from lidarcrafter_tpu_torch.training.state import TrainState, named_module_params
from lidarcrafter_tpu_torch.training.train_step import Bf16Forward
from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_points, synthetic_scene_graphs
from lidarcrafter_tpu_torch.weights import load_flax_params

LR, WARMUP, NUM_STEPS = 1e-3, 2, 10
MAX_NODES, MAX_EDGES = 16, 64


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _training(cfg):
    t = cfg.training
    t.lr, t.lr_warmup_steps, t.num_steps, t.ema_update_every, t.mixed_precision = LR, WARMUP, NUM_STEPS, 1, "no"
    return cfg


def _one_level(configs):
    """The layout tests' small stack at one UNet level (the JAX step's
    compile is most of this file's time)."""
    cfg = layout_small(configs)
    cfg.model.params["channel_mult"] = (1,)
    return cfg


# ------------------------------------------------------------------ (a)


def test_pad_layout_batch_equals_jax_exactly():
    batch = synthetic_scene_graphs(2, 4, seed=3)
    for budgets in ((MAX_NODES, MAX_EDGES), (10, 57), (24, 200)):
        got, want = dict(_flat(pad_layout_batch(batch, *budgets))), dict(_flat(j_pad_layout_batch(batch, *budgets)))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    with pytest.raises(ValueError, match="exceeds budgets"):
        pad_layout_batch(batch, 9, 64)


def test_layout_budgets_default_to_the_worst_case_and_grow():
    cfg = _training(layout_small(tcfgs))
    cfg.training.batch_size_train = 8
    trainer = LayoutTrainer(cfg, iter(()), log_fn=None, device="cpu")
    assert (trainer.max_nodes, trainer.max_edges) == (112, 3536)
    logs = []
    trainer = LayoutTrainer(cfg, iter(()), max_nodes=8, max_edges=16, log_fn=logs.append, device="cpu")
    batch = trainer.prepare_batch(synthetic_scene_graphs(2, 4, seed=3))  # 10 nodes, 57 triples
    assert (trainer.max_nodes, trainer.max_edges) == (16, 64)
    assert logs == [{"layout_budget_grow": {"max_nodes": 16, "max_edges": 64}}]
    assert batch["boxes"].shape == (16, 40) and batch["scenegraph"]["triples"].shape == (64, 3)
    assert batch["scenegraph"]["triples"].dtype == torch.int64 and int(batch["scenegraph"]["edge_mask"].sum()) == 57


def test_layout_ema_follows_the_trained_tensors_by_name():
    """The EMA of the layout models holds a copy of every trained tensor,
    running statistics included, matched by name, none requiring grad."""
    trainer = LayoutTrainer(_training(layout_small(tcfgs)), iter(()), log_fn=None, device="cpu")
    state = TrainState.create(trainer.models, trainer.optimizer)
    names = [n for n, _ in named_module_params(trainer.models)]
    assert any(n.endswith("running_var") for n in names)
    online, ema = state.params(), state.ema_params()
    assert len(ema) == len(online) == len(names)
    assert all(e is not o and torch.equal(e, o) for e, o in zip(ema, online))
    assert not any(t.requires_grad for m in state.ema.values() for t in (*m.parameters(), *m.buffers()))


def test_amp_forward_casts_the_running_statistics():
    """bf16 AMP casts a module's persistent floating buffers (the running
    statistics) with its parameters, as the JAX AMP casts its whole tree;
    a module without them casts only its parameters."""
    bn = MaskedBatchNorm(4)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
        bn.weight.uniform_(0.5, 2)
    x = torch.randn(5, 4)
    amp = Bf16Forward(bn)
    assert amp.cast_buffers == {"running_mean", "running_var"} and Bf16Forward(torch.nn.Linear(4, 4)).cast_buffers == set()
    want = MaskedBatchNorm(4).to(torch.bfloat16)
    want.load_state_dict(bn.state_dict())
    got = amp(x)
    assert got.dtype == torch.float32 and torch.equal(got, want(x.to(torch.bfloat16)).float())


# ------------------------------------------------------------------ (b)


class _Step:
    """One step of a port trainer and of the JAX ``make_train_step`` on the
    same weights, batch and draws: both losses and both gradients."""

    def __init__(self, trainer, params: dict, jengine, jbatch, batch, draws: dict, monkeypatch, **jax_kw):
        for k, m in trainer.models.items():
            load_flax_params(m, params[k])
        names = [n for n, _ in named_module_params(trainer.models)]
        self.grads, update = {}, AdamW.update_

        def capture(opt, trained, grads, opt_state):  # the step's gradients, before the clip scales them
            self.grads.update((n, g.clone()) for n, g in zip(names, grads))
            update(opt, trained, grads, opt_state)

        monkeypatch.setattr(AdamW, "update_", capture)
        state = TrainState.create(trainer.models, trainer.optimizer)
        _, loss = trainer.step_fn(state, trainer.prepare_batch(batch), 0, **draws)
        self.loss = float(loss)
        tx = optax.chain(_capture(), j_make_optimizer(lr=LR, warmup_steps=WARMUP, num_steps=NUM_STEPS))
        jstep = j_make_train_step(jengine, tx, donate=False, ema_update_every=1, ema_update_after_step=WARMUP,
                                  **jax_kw)
        jstate, jloss = jstep(JState.create(params, tx), jbatch, jax.random.PRNGKey(7))
        self.jloss = float(jloss)
        self.jgrads = _state_dicts(jstate.opt_state[0], trainer.models)


def _layout_draws():
    """The JAX layout step's per-scene t and noise at step 0."""
    rng_t, rng_q = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 0))
    t_scene = jax.random.uniform(rng_t, (SCENES,), dtype=jnp.float32)
    noise = jax.random.normal(jax.random.split(rng_q)[0], (MAX_NODES, 20), jnp.float32)
    return {"t_scene": torch.as_tensor(np.asarray(t_scene)), "noise": torch.as_tensor(np.asarray(noise))}


def test_layout_trainer_step_matches_jax(monkeypatch):
    stack = LayoutStack(_one_level)
    assert stack.N < MAX_NODES and stack.T < MAX_EDGES  # the padding shows in the loss
    trainer = LayoutTrainer(_training(_one_level(tcfgs)), iter(()), max_nodes=MAX_NODES, max_edges=MAX_EDGES,
                            log_fn=None, device="cpu")
    jbatch = j_pad_layout_batch(stack.batch, MAX_NODES, MAX_EDGES)
    draws = _layout_draws()
    step = _Step(trainer, stack.params, stack.jengine, jbatch, stack.batch, draws, monkeypatch,
                 loss_kwargs={"num_scenes": SCENES})
    assert step.loss == pytest.approx(step.jloss, rel=1e-5)
    stats = [n for n in step.jgrads if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 2 * (2 * 2 * 2) + 2 * 5 * 2 * 2  # SceneGraph: 2 GCNs x 2 layers; UNet box GCN: 5
    assert all(n in step.grads for n in stats)
    trained = {n: float(step.jgrads[n].norm()) > 0 for n in stats}
    assert trained == {n: n.startswith("model.") for n in stats}
    _assert_grads(step.grads, step.jgrads)

    # the loss is a mean over the budget: twice the budget, half the loss
    engine, num_scenes = trainer.engine, SCENES
    loss = {}
    for rows in (MAX_NODES, 2 * MAX_NODES):
        noise = torch.zeros(rows, 20)
        noise[:MAX_NODES] = draws["noise"]
        batch = trainer.prepare_batch(pad_layout_batch(stack.batch, rows, MAX_EDGES))
        with torch.no_grad():
            loss[rows] = float(engine.loss(batch, num_scenes, t_scene=draws["t_scene"], noise=noise))
    assert loss[2 * MAX_NODES] == pytest.approx(loss[MAX_NODES] / 2, rel=1e-6)


def test_object_trainer_step_matches_jax(monkeypatch):
    stack = ObjectStack()
    points = synthetic_object_points(2, 3, POINTS, seed=4)
    np.testing.assert_array_equal(points["fg_encoding_box"], stack.boxes["fg_encoding_box"])
    trainer = ObjectTrainer(_training(object_small(tcfgs)), iter(()), stack.boxes["fg_text_features"],
                            log_fn=None, device="cpu")
    t, noise, _ = jax_draws(jax.random.PRNGKey(7), 0, points["fg_points"].shape)
    jbatch = dict(stack.jinput, x_0=jnp.asarray(points["fg_points"]))
    step = _Step(trainer, stack.params, stack.jengine, jbatch, points, {"t": t, "noise": noise}, monkeypatch)
    assert step.loss == pytest.approx(step.jloss, rel=1e-5)
    _assert_grads(step.grads, step.jgrads)


# ------------------------------------------------------------------ (c)


def _cli(cfg_name: str, out, *extra):
    train_cli.main(["-c", cfg_name, "--synthetic-data", "--num-steps", "2", "--device", "cpu",
                    "--checkpoint-every", "2", "--output-dir", str(out), *extra])
    path = latest_checkpoint(out)
    assert path.endswith("ckpt_0000000002")
    return path, torch.load(f"{path}/state.pt", weights_only=True)


def _assert_ema_served(gen, saved):
    for key, module in gen.models.items():
        for name, value in module.state_dict().items():
            assert torch.equal(value, saved["ema"][key][name]), f"{key}.{name}"


def test_train_cli_layout_two_steps_and_its_checkpoint_serves(tmp_path, capsys):
    path, saved = _cli("nuscenes-layout", tmp_path / "run", "--model-channels", "64", "-b", "1")
    assert "'step': 2" in capsys.readouterr().out
    assert saved["step"] == 2 and any(k.endswith("running_var") for k in saved["ema"]["cond"])
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-layout"), model_channels=64)
    _assert_ema_served(generate_layout.LayoutGenerator(cfg, "cpu", ckpt=path), saved)
    out = tmp_path / "layout.pkl"
    generate_layout.main(["--synthetic", "1", "--objects", "3", "--ckpt", path, "--model-channels", "64",
                          "--num-steps", "2", "--mode", "ddim", "--device", "cpu", "-o", str(out)])
    with open(out, "rb") as f:
        assert np.isfinite(pickle.load(f)["raw"]).all()


def test_train_cli_object_two_steps_and_its_checkpoint_serves(tmp_path, capsys):
    text = tmp_path / "text.pkl"
    with open(text, "wb") as f:
        pickle.dump(np.full((8, 512), 0.01, np.float32), f)
    path, saved = _cli("nuscenes-object", tmp_path / "run", "--text-features", str(text), "-b", "2")
    assert "'step': 2" in capsys.readouterr().out
    _assert_ema_served(generate_object.ObjectGenerator(tcfgs.get_config("nuscenes-object"), "cpu", ckpt=path), saved)
    out = tmp_path / "objects.pkl"
    generate_object.main(["--synthetic", "1", "--objects", "2", "--ckpt", path, "--num-steps", "2", "--mode", "ddim",
                          "--device", "cpu", "-o", str(out)])
    with open(out, "rb") as f:
        clouds = pickle.load(f)
    assert clouds.shape == (2, 1024, 4) and np.isfinite(clouds).all()
