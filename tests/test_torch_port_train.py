"""Training in the PyTorch port against the JAX package, on the CPU.

(b) ``criterion``, ``get_target``, ``get_loss_weight``, ``p_loss`` and
    ``loss`` of both engines for eps / v / x_0 prediction and l2 / l1 /
    huber losses, the conditional engine with ``w_loss_weight``, on a toy
    denoiser and encoder that both packages compute alike; t and the noise
    come from the JAX key chain (``fold_in`` → ``split`` → ``uniform`` /
    ``normal``).  Limit 1e-6 relative.
(c) ``cosine_warmup_schedule``, the global-norm clip, AdamW with and
    without ``MultiSteps`` accumulation (k = 2), ``ema_update`` and
    ``ema_decay_schedule`` against optax and the JAX ``ema.py`` over 30
    steps of random gradients whose norm falls on both sides of the clip.
(d) One and three ``make_train_step`` steps of the ``small``
    ``nuscenes-auto-reg-v2`` stack (``torch_port_harness.Pair``) and of the
    reduced ``nuscenes-unet-uncond`` (``UncondPair``) against the JAX
    ``make_train_step(donate=False)`` with shared weights and the JAX
    step's t and noise injected.  The JAX step's gradients are read from
    its own optimizer state: an identity transformation chained before the
    optimizer keeps the last update it saw.  Loss to 1e-5 relative;
    gradients to 1e-4 relative L2 per tensor and 1e-5 overall; parameters
    and EMA after 3 steps to 1e-3·lr.  A tensor whose gradient is zero up
    to float32 rounding (below 1e-6 of the overall norm: in the reduced
    stacks every 32-group norm of 32 channels takes one channel a group,
    which zeroes the gradient of a conv bias right before it) is held to
    1e-6 of the overall norm instead of its own.
(e) bf16 AMP against JAX ``amp=True`` (``amp_engine``): the loss to 5e-2
    relative.  For the gradients the JAX reference on the CPU is coarse:
    XLA:CPU sums bf16 products in bf16, so its AMP gradients lie ~0.13
    (relative L2) from its own float32 ones, where the port's, which sum in
    float32 as the card's tensor cores do, lie ~0.015 from them.  The
    port's AMP gradients are therefore held to the JAX float32 gradients,
    to 5e-2 relative L2 overall, and to be no farther from them than JAX's
    own AMP gradients are.
(f) Save → resume → continue through ``Trainer`` equals an unbroken run,
    bit for bit.
(g) The ``train`` CLI for 2 steps on ``--device cpu``, and its checkpoint
    read back by the serving CLIs' loader (EMA weights, bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
from torch_port_harness import Pair, UncondPair, one_torch_thread, shrink  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.diffusion import CondContinuousDiffusion as JCond
from lidarcrafter_tpu.diffusion import ContinuousDiffusion as JUncond
from lidarcrafter_tpu.training import ema as jema
from lidarcrafter_tpu.training.optim import cosine_warmup_schedule as j_schedule
from lidarcrafter_tpu.training.optim import make_optimizer as j_make_optimizer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu.training.train_step import amp_engine as j_amp_engine
from lidarcrafter_tpu.training.train_step import make_train_step as j_make_train_step
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.diffusion import CondContinuousDiffusion, ContinuousDiffusion
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
from lidarcrafter_tpu_torch.training import ema as tema
from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint
from lidarcrafter_tpu_torch.training.loop import Trainer
from lidarcrafter_tpu_torch.training.optim import cosine_warmup_schedule, make_optimizer
from lidarcrafter_tpu_torch.training.state import TrainState
from lidarcrafter_tpu_torch.training.train_step import amp_engine, loss_and_grads, make_train_step
from lidarcrafter_tpu_torch.weights import flax_to_state_dict

LR, WARMUP, NUM_STEPS = 1e-3, 2, 10
H, W = 32, 128


def jax_draws(key, step: int, x_shape):
    """t and the noise of JAX step ``step``: ``fold_in`` → ``split`` →
    ``uniform`` (t) / ``normal`` (the noise, in ``q_step_from_x_0``)."""
    rng_t, rng_q = jax.random.split(jax.random.fold_in(key, step))
    t = jax.random.uniform(rng_t, (x_shape[0],), dtype=jnp.float32)
    noise = jax.random.normal(rng_q, x_shape, jnp.float32)
    return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(noise)), rng_q


# ------------------------------------------------------------------ (b)


class ToyDenoiser(nn.Module):
    """x·a + log-SNR·b (+ the condition's c): the same function as the
    JAX ``apply_fn`` below."""

    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = nn.Parameter(torch.as_tensor(a)), nn.Parameter(torch.as_tensor(b))

    def forward(self, x, cond):
        if isinstance(cond, dict):
            return x * self.a + cond["time_condition"][:, None, None, None] * self.b + cond["other_condition"]["c"]
        return x * self.a + cond[:, None, None, None] * self.b


class ToyEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = nn.Parameter(torch.as_tensor(c))

    def forward(self, batch):
        return {"c": batch["m"] * self.c}


@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
@pytest.mark.parametrize("prediction_type", ["eps", "v", "x_0"])
def test_losses_match_jax(prediction_type, loss_type):
    rnd = np.random.RandomState(3)
    B, shape = 3, (3, 4, 6, 2)
    x_0 = rnd.uniform(-1, 1, shape).astype(np.float32)
    p = {k: (2.0 * rnd.standard_normal(shape[1:])).astype(np.float32) for k in ("a", "b", "c")}
    batch = {"x_0": x_0, "m": rnd.standard_normal(shape).astype(np.float32),
             "scene_loss_weight_map": rnd.uniform(0.5, 2.0, shape[:3]).astype(np.float32)}
    kw = dict(sampling_shape=shape[1:], prediction_type=prediction_type, loss_type=loss_type,
              min_snr_loss_weight=loss_type != "l1")  # l1 also covers the unclipped SNR weight
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_un = JUncond(apply_fn=lambda q, x, s: x * q["a"] + s[:, None, None, None] * q["b"], **kw)
    j_cond = JCond(
        apply_fn=lambda q, x, cd: x * q["a"] + cd["time_condition"][:, None, None, None] * q["b"]
        + cd["other_condition"]["c"],
        cond_apply_fn=lambda q, d: {"c": d["m"] * q["c"]}, cond_mode="concat", w_loss_weight=True, **kw,
    )
    t_un = ContinuousDiffusion(model=ToyDenoiser(p["a"], p["b"]), **kw)
    t_cond = CondContinuousDiffusion(model=t_un.model, cond_model=ToyEncoder(p["c"]), w_loss_weight=True, **kw)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    key = jax.random.PRNGKey(11)
    t, noise, rng_q = jax_draws(key, 4, shape)
    step_rng = jax.random.fold_in(key, 4)
    jt = jnp.asarray(t.numpy())

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    close(t_un.criterion(tb["x_0"], noise), j_un.criterion(jb["x_0"], jnp.asarray(noise.numpy())))
    close(t_un.get_target(tb["x_0"], t, noise), j_un.get_target(jb["x_0"], jt, jnp.asarray(noise.numpy())))
    close(t_un.get_loss_weight(t), j_un.get_loss_weight(jt))
    close(t_un.p_loss(tb["x_0"], t, noise), j_un.p_loss(jp, rng_q, jb["x_0"], jt))
    close(t_un.loss(tb["x_0"], t=t, noise=noise), j_un.loss(jp, step_rng, jb["x_0"]))
    # the conditional engine: encoder under autograd, the weight map as the mask
    close(t_cond.p_loss(tb, t, noise), j_cond.p_loss(jp, rng_q, jb, jt))
    got = t_cond.loss(tb, t=t, noise=noise)
    close(got, j_cond.loss(jp, step_rng, jb))
    assert got.requires_grad and torch.autograd.grad(got, t_cond.cond_model.c)[0].abs().sum() > 0


def test_q_step_matches_jax():
    """q(z_t | z_s) with the noise JAX draws from the same key."""
    rnd = np.random.RandomState(6)
    shape = (3, 4, 6, 2)
    x_s = rnd.uniform(-1, 1, shape).astype(np.float32)
    t, s = np.array([0.9, 0.5, 0.3], np.float32), np.array([0.2, 0.4, 0.1], np.float32)
    key = jax.random.PRNGKey(2)
    engine = JUncond(apply_fn=None, sampling_shape=shape[1:])
    want = np.asarray(engine.q_step(jnp.asarray(x_s), jnp.asarray(t), jnp.asarray(s), key))
    noise = torch.tensor(np.asarray(jax.random.normal(key, shape, jnp.float32)))
    port = ContinuousDiffusion(model=nn.Identity(), sampling_shape=shape[1:])
    got = port.q_step(torch.as_tensor(x_s), torch.as_tensor(t), torch.as_tensor(s), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_loss_draws_t_then_noise_from_the_generator():
    model = ToyDenoiser(np.ones((4, 6, 2), np.float32), np.zeros((4, 6, 2), np.float32))
    engine = ContinuousDiffusion(model=model, sampling_shape=(4, 6, 2))
    x_0 = torch.zeros(2, 4, 6, 2)
    gen = torch.Generator().manual_seed(5)
    t = torch.rand(2, generator=gen)
    noise = torch.randn(x_0.shape, generator=gen)
    want = engine.p_loss(x_0, t, noise)
    assert torch.equal(engine.loss(x_0, generator=torch.Generator().manual_seed(5)), want)


# ------------------------------------------------------------------ (c)


def test_schedules_match_jax():
    """The JAX schedule runs in float32 and the port's in float64: they
    agree to 1e-6 relative or 1e-6 of the base LR (float32 rounds the
    cosine's argument π·progress by up to 2.4e-7, which moves a small LR
    near the end of the decay by more than 1e-6 of itself)."""
    for warmup in (0, 5):
        jax_lr, port_lr = j_schedule(1e-3, warmup, 30), cosine_warmup_schedule(1e-3, warmup, 30)
        for count in range(40):
            assert port_lr(count) == pytest.approx(float(jax_lr(count)), rel=1e-6, abs=1e-6 * 1e-3)
    assert cosine_warmup_schedule(1e-3, 5, 30)(0) == 0.0
    for step in range(0, 400, 7):
        want = float(jema.ema_decay_schedule(jnp.asarray(step), 0.995, 100))
        assert tema.ema_decay_schedule(step, 0.995, 100) == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_and_ema_match_optax_over_30_steps(accum):
    rnd = np.random.RandomState(accum)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rnd.standard_normal(s).astype(np.float32) for s in shapes]
    opt_kw = dict(lr=1e-2, warmup_steps=5, num_steps=30, weight_decay=1e-2, grad_accum_steps=accum)
    ema_kw = dict(beta=0.9, update_every=2, update_after_step=3)
    tx = j_make_optimizer(**opt_kw)
    tx_update = jax.jit(tx.update)
    ema_update = jax.jit(lambda e, o, step: jema.ema_update(e, o, step, **ema_kw))
    jp = [jnp.asarray(a) for a in params]
    jstate, jema_p = tx.init(jp), [jnp.asarray(a) for a in params]
    opt = make_optimizer(**opt_kw)
    tp = [torch.tensor(a) for a in params]
    tstate, tema_p = opt.init(tp), [torch.tensor(a) for a in params]
    clipped = 0
    for step in range(30):
        # global norms between ~0.35 and ~3.5: the clip at 1.0 acts on some steps
        g = [(rnd.standard_normal(s) * 10 ** rnd.uniform(-1.3, -0.3)).astype(np.float32) for s in shapes]
        clipped += np.sqrt(sum((a**2).sum() for a in g)) > 1.0
        updates, jstate = tx_update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        jema_p = ema_update(jema_p, jp, jnp.asarray(step))
        opt.update_(tp, [torch.tensor(a) for a in g], tstate)
        tema.ema_update_(tema_p, tp, step, **ema_kw)
        for got, want in zip(tp + tema_p, jp + jema_p):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert 5 <= clipped <= 25


# ------------------------------------------------------------------ (d), (e)


def _capture():
    """Identity on the updates that keeps the last ones in its state: the
    JAX train step's gradients, read from its optimizer state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params), lambda u, s, params=None: (u, u)
    )


def _state_dicts(tree, modules: dict) -> dict:
    """A flax tree ({'model', 'cond'} or one model's) → {key.name: tensor}."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if set(modules) == {"model"}:
        tree = {"model": tree}
    return {f"{k}.{n}": v for k, m in modules.items() for n, v in flax_to_state_dict(tree[k], m).items()}


def _named(state: TrainState, which: str = "models") -> dict:
    modules = getattr(state, which)
    return {f"{k}.{n}": p.detach() for k in sorted(modules) for n, p in modules[k].named_parameters()}


def _assert_grads(got: dict, want: dict, per_tensor: float = 1e-4, overall: float = 1e-5):
    total = np.sqrt(sum(float(w.norm()) ** 2 for w in want.values()))
    num = 0.0
    for name, w in want.items():
        d = float((got[name] - w).norm())
        num += d**2
        if float(w.norm()) >= 1e-6 * total:
            assert d <= per_tensor * float(w.norm()), (name, d, float(w.norm()))
        else:  # zero up to float32 rounding
            assert d <= 1e-6 * total, (name, d, total)
    assert np.sqrt(num) <= overall * total


def _assert_params(got: dict, want: dict, jax_grads: list[dict]):
    """Parameters after the steps to 1e-3·lr, on the elements where Adam is
    well conditioned: at every step the element's gradient is at least 1e-3
    of the gradient's RMS over all elements.  Adam divides each gradient by
    its own running RMS, so on an element whose gradient is zero up to
    rounding (a key bias under softmax, a conv bias before a one-channel
    norm) it turns rounding noise into an O(lr) step of either sign; those
    elements (4% of the layout stack's, 3% of the uncond's) are held only
    to Adam's own step bound, 3·lr over the two steps whose LR is not 0."""
    total = sum(p.numel() for p in want.values())
    rms = [np.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()) / total) for grads in jax_grads]
    excluded = 0
    for name, w in want.items():
        keep = torch.ones_like(w, dtype=torch.bool)
        for grads, r in zip(jax_grads, rms):
            keep &= grads[name].abs() >= 1e-3 * r
        err = (got[name] - w).abs()
        excluded += int((~keep).sum())
        kept = float(torch.where(keep, err, 0.0).max())
        assert kept <= 1e-3 * LR, (name, kept)
        assert float(err.max()) <= 3 * LR, (name, float(err.max()))
    assert excluded <= 0.1 * total


class _Run:
    """A stack built by both packages with shared weights, its batch, and
    both train steps."""

    def __init__(self, kind: str):
        B = 2
        rnd = np.random.RandomState(4)
        x_0 = np.clip(0.5 * rnd.standard_normal((B, H, W, 2)), -1, 1).astype(np.float32)
        if kind == "layout":
            pair = Pair("nuscenes-auto-reg-v2", small=True, batch_size=B, seed=0)
            self.modules, params = pair.tmodels, pair.params
            self.jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()} | {"x_0": jnp.asarray(x_0)}
            self.tbatch = {k: torch.as_tensor(v) for k, v in pair.batch.items()} | {"x_0": torch.as_tensor(x_0)}
        else:
            pair = UncondPair("nuscenes-unet-uncond", seed=0)
            self.modules, params = {"model": pair.tmodel}, pair.params
            self.jbatch, self.tbatch = jnp.asarray(x_0), torch.as_tensor(x_0)
        self.pair, self.x_shape = pair, x_0.shape
        self.key = jax.random.PRNGKey(7)
        tx = optax.chain(_capture(), j_make_optimizer(lr=LR, warmup_steps=WARMUP, num_steps=NUM_STEPS))
        ema_kw = dict(ema_update_every=1, ema_update_after_step=0)
        self.jstep = j_make_train_step(pair.jengine, tx, donate=False, **ema_kw)
        self.jstate = JState.create(params, tx)
        self.tstep = make_train_step(pair.tengine, make_optimizer(lr=LR, warmup_steps=WARMUP, num_steps=NUM_STEPS),
                                     **ema_kw)
        self.tstate = TrainState.create(self.modules, make_optimizer(lr=LR, warmup_steps=WARMUP,
                                                                     num_steps=NUM_STEPS))
        self.losses, self.grads = [], []

    def step(self):
        """One step of each; keeps both losses and both gradients."""
        step = self.tstate.step
        t, noise, _ = jax_draws(self.key, step, self.x_shape)
        _, grads = loss_and_grads(self.pair.tengine, self.tstate.params(), self.tbatch, t=t, noise=noise)
        names = list(_named(self.tstate))
        self.jstate, jloss = self.jstep(self.jstate, self.jbatch, self.key)
        self.tstate, tloss = self.tstep(self.tstate, self.tbatch, 0, t=t, noise=noise)
        self.losses.append((float(tloss), float(jloss)))
        self.grads.append((dict(zip(names, grads)), _state_dicts(self.jstate.opt_state[0], self.modules)))


def _three_steps(kind: str) -> _Run:
    r = _Run(kind)
    for _ in range(3):
        r.step()
    return r


@pytest.fixture(scope="module")
def layout_run():
    return _three_steps("layout")


@pytest.fixture(scope="module")
def uncond_run():
    return _three_steps("uncond")


@pytest.fixture(params=["layout", "uncond"])
def run(request):
    return request.getfixturevalue(f"{request.param}_run")


def test_one_train_step_matches_jax(run):
    got, want = run.losses[0]
    assert got == pytest.approx(want, rel=1e-5)
    _assert_grads(*run.grads[0])


def test_three_train_steps_match_jax(run):
    for got, want in run.losses:
        assert got == pytest.approx(want, rel=1e-5)
    _assert_grads(*run.grads[2])
    assert run.tstate.step == int(run.jstate.step) == 3
    jax_grads = [g[1] for g in run.grads]
    for which, tree in (("models", run.jstate.params), ("ema", run.jstate.ema_params)):
        _assert_params(_named(run.tstate, which), _state_dicts(tree, run.modules), jax_grads)
    # the parameters did move: lr(1) = lr/2 and lr(2) = lr under the warmup
    start = _state_dicts(run.pair.params, run.modules)
    assert max(float((p - start[n]).abs().max()) for n, p in _named(run.tstate).items()) > LR


def test_amp_matches_jax_amp(layout_run):
    """On the layout stack's first step (the same weights, batch and
    draws as ``layout_run``'s, whose JAX float32 gradients it reuses)."""
    pair = Pair("nuscenes-auto-reg-v2", small=True, batch_size=2, seed=0)
    x_0 = layout_run.tbatch["x_0"]
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()} | {"x_0": jnp.asarray(x_0.numpy())}
    tbatch = {k: torch.as_tensor(v) for k, v in pair.batch.items()} | {"x_0": x_0}
    t, noise, _ = jax_draws(layout_run.key, 0, x_0.shape)
    params = [p for k in sorted(pair.tmodels) for p in pair.tmodels[k].parameters()]
    names = [f"{k}.{n}" for k in sorted(pair.tmodels) for n, _ in pair.tmodels[k].named_parameters()]
    engine = j_amp_engine(pair.jengine)
    key = jax.random.fold_in(layout_run.key, 0)
    j_amp_loss, grads = jax.jit(jax.value_and_grad(lambda p: engine.loss(p, key, jbatch)))(pair.params)
    j_amp, j_f32 = _state_dicts(grads, pair.tmodels), layout_run.grads[0][1]
    t_loss, t_amp = loss_and_grads(amp_engine(pair.tengine), params, tbatch, t=t, noise=noise)
    t_amp = dict(zip(names, t_amp))
    assert all(g.dtype == torch.float32 for g in t_amp.values())  # master gradients
    assert float(t_loss) == pytest.approx(float(j_amp_loss), rel=5e-2)

    def rel(a, b):
        return np.sqrt(sum(float((a[n] - b[n]).norm()) ** 2 for n in b) / sum(float(b[n].norm()) ** 2 for n in b))

    port_err, jax_err = rel(t_amp, j_f32), rel(j_amp, j_f32)
    assert port_err <= 5e-2
    assert port_err <= jax_err, (port_err, jax_err)


# ------------------------------------------------------------------ (f), (g)


def _small_cfg():
    cfg = shrink(tcfgs, "nuscenes-auto-reg-v2", small=True)
    t = cfg.training
    t.batch_size_train, t.mixed_precision, t.lr, t.lr_warmup_steps = 1, "no", 1e-3, 1
    t.ema_update_every = 1
    return cfg


def _batches(cfg, n: int):
    out = []
    for i in range(n):
        gen = torch.Generator().manual_seed(i)
        batch = train_cli.synthetic_layout_batches(cfg, seed=i)
        out.append(next(batch) | {"x_0": torch.rand(1, H, W, 2, generator=gen) * 2 - 1})
    return out


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    opt = state.opt_state
    return state.params() + state.ema_params() + opt["mu"] + opt["nu"]


def test_resume_equals_an_unbroken_run(tmp_path):
    cfg = _small_cfg()
    batches = _batches(cfg, 4)
    unbroken = Trainer(cfg, iter(batches), output_dir=tmp_path / "a", log_fn=None, device="cpu")
    whole = unbroken.train(num_steps=4, seed=3, checkpoint_every=2)
    broken = Trainer(cfg, iter(batches[2:]), output_dir=tmp_path / "a", log_fn=None, device="cpu")
    path = latest_checkpoint(tmp_path / "a")
    assert path.endswith("ckpt_0000000004")
    resumed = broken.train(num_steps=4, seed=3, resume=str(tmp_path / "a" / "ckpt_0000000002"))
    assert resumed.step == whole.step == 4
    assert resumed.opt_state["count"] == whole.opt_state["count"] == 4
    for a, b in zip(_state_tensors(resumed), _state_tensors(whole), strict=True):
        assert torch.equal(a, b)


def test_train_cli_two_steps_and_its_checkpoint_serves(tmp_path, capsys):
    out = tmp_path / "run"
    train_cli.main(["-c", "nuscenes-auto-reg-v2", "--synthetic-data", "--num-steps", "2", "--device", "cpu",
                    "--resolution", str(H), str(W), "--model-channels", "32", "-b", "1",
                    "--checkpoint-every", "2", "--output-dir", str(out)])
    logs = capsys.readouterr().out
    assert "'step': 2" in logs
    path = latest_checkpoint(out)
    assert path.endswith("ckpt_0000000002")
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-auto-reg-v2"), resolution=(H, W),
                                       model_channels=32)
    gen = CondFrameGenerator(cfg, "cpu", ckpt=path)
    saved = torch.load(f"{path}/state.pt", weights_only=True)
    assert saved["step"] == 2
    for key, module in gen.models.items():
        for name, value in module.state_dict().items():
            assert torch.equal(value, saved["ema"][key][name])
    sample, _ = gen.generate(1, 1, mode="ddim")
    assert torch.isfinite(sample).all()
    with pytest.raises(SystemExit, match="not ported"):
        train_cli.main(["-c", "nuscenes-auto-reg-v2", "--device", "cpu"])
