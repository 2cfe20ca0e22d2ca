"""Training the MeanFlow branch in the PyTorch port against the JAX package,
on the CPU.

(a) The forward-mode rules of the kernel routes: ``attention_jvp`` and
    ``group_norm_jvp`` against ``jax.jvp`` of the JAX package's plain
    functions (the attention einsum of ``MFSelfAttention2d``, with a masked
    key tail added as ``where``; ``_gn_ref`` of ``ops/pallas_groupnorm.py``
    with the scale-shift folded as the modules fold it), in float32 and
    bfloat16, to 1e-5 and 2e-2 of the largest tangent.  Then the
    ``Attention`` / ``GroupNorm`` Functions with the kernel launch replaced
    by the plain version (which first reads every operand's pointer, as the
    launch does: ``test_torch_port_backward._plain_launches``) under
    ``torch.func.jvp`` and under ``forward_ad``: the
    tangent equals the plain version's (1e-5 relative) and a backward
    through the primal equals autograd through the plain version.
(b) ``MeanFlow.loss`` of the reduced ``meanflow-nusc``
    (``torch_port_harness.UncondPair``) against the JAX ``MeanFlow.loss``
    with shared weights and the JAX key chain's t, r and noise injected:
    loss and mse to 1e-5 relative, every gradient to 1e-4 relative L2;
    ``sample_t_r``'s r ≤ t and its ``flow_ratio`` share.
(c) One ``FlowTrainer`` step against the JAX ``make_train_step`` (the JAX
    step's gradients read from an identity transformation chained before
    its optimizer, as ``test_torch_port_train.py`` does), and the same step
    under bf16 AMP held as that file holds AMP.
(d) The ``train`` CLI for 2 steps of ``meanflow-nusc`` on the CPU, its
    checkpoint served through ``generate_flow --ckpt`` (online weights, or
    EMA with ``--ema``, bit for bit).
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_backward import GN_CASES, TOL, _draw, _pair, _plain_launches
from test_torch_port_train import _assert_grads, _capture, _state_dicts
from torch.autograd import forward_ad
from torch_port_harness import RESOLUTION, UncondPair, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.ops.pallas_groupnorm import _gn_ref
from lidarcrafter_tpu.training.optim import make_optimizer as j_make_optimizer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu.training.train_step import amp_engine as j_amp_engine
from lidarcrafter_tpu.training.train_step import make_train_step as j_make_train_step
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import generate_flow
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.diffusion import MeanFlow
from lidarcrafter_tpu_torch.kernels import attention, groupnorm, loader
from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint
from lidarcrafter_tpu_torch.training.loop import FlowTrainer
from lidarcrafter_tpu_torch.training.optim import AdamW
from lidarcrafter_tpu_torch.training.state import TrainState
from lidarcrafter_tpu_torch.training.train_step import amp_engine, loss_and_grads

LR, WARMUP, NUM_STEPS = 1e-3, 2, 10
B = 2


def _assert_tangent(got, want, dname):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL[dname] * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------------ (a)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,Lkv,kv_len", [(24, 24, None), (20, 32, 17)])
def test_attention_jvp_matches_jax_jvp(dname, Lq, Lkv, kv_len):
    """The plain attention of ``MFSelfAttention2d`` ((B, L, heads, d)
    operands, q pre-scaled there; here the scale is on the logits)."""
    H, d = 2, 16
    rnd = np.random.RandomState(Lq + Lkv)
    arrays = [_draw(rnd, B, H, Lq, d), _draw(rnd, B, H, Lkv, d), _draw(rnd, B, H, Lkv, d)]
    (q, k, v), (jq, jk, jv) = _pair(arrays, dname)
    (tq, tk, tv), (jtq, jtk, jtv) = _pair([_draw(rnd, *a.shape) for a in arrays], dname)
    scale = 1.0 / math.sqrt(d)
    got = attention.attention_jvp(q, k, v, tq, tk, tv, scale=scale, kv_len=kv_len)
    assert got.dtype == q.dtype and got.transpose(1, 2).is_contiguous()  # the kernel's output layout

    def f(q, k, v):
        bl = lambda t: t.transpose(0, 2, 1, 3)  # noqa: E731
        logits = jnp.einsum("blhd,bmhd->bhlm", bl(q) * scale, bl(k))
        if kv_len is not None:
            logits = jnp.where(jnp.arange(Lkv) < kv_len, logits, -jnp.inf)
        w = jax.nn.softmax(logits, axis=-1)
        return bl(jnp.einsum("bhlm,bmhd->blhd", w, bl(v)))

    _, want = jax.jvp(f, (jq, jk, jv), (jtq, jtk, jtv))
    _assert_tangent(got, want, dname)
    # a None tangent is a zero one
    _, want_v = jax.jvp(f, (jq, jk, jv), (jnp.zeros_like(jq), jnp.zeros_like(jk), jtv))
    _assert_tangent(attention.attention_jvp(q, k, v, None, None, tv, scale=scale, kv_len=kv_len), want_v, dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GN_CASES))
def test_group_norm_jvp_matches_jax_jvp(dname, case):
    """Tangents on x, weight, bias and the strided scale / shift halves of
    one (B, 2C) projection; ``_gn_ref`` takes the folded γ = w(1+s),
    β = b(1+s) + t, folded here in float32."""
    affine, ss, silu = GN_CASES[case]
    H, W, C, G, eps = 4, 8, 32, 8, 1e-6
    rnd = np.random.RandomState(len(case))
    arrays = [_draw(rnd, B, H, W, C, scale=2.0) + 1.0, 1.0 + _draw(rnd, C, scale=0.1), _draw(rnd, C, scale=0.1),
              _draw(rnd, B, 2 * C, scale=0.3)]
    (x, w, b, proj), jops = _pair(arrays, dname)
    tans, jtans = _pair([_draw(rnd, *a.shape) for a in arrays], dname)
    s, t = proj.chunk(2, dim=-1)
    ds, dt = tans[3].chunk(2, dim=-1)
    saved = (x, w if affine else None, b if affine else None, s if ss else None, t if ss else None)
    tangents = (tans[0], tans[1] if affine else None, tans[2] if affine else None, ds if ss else None,
                dt if ss else None)
    got = groupnorm.group_norm_jvp(saved, tangents, num_groups=G, eps=eps, silu=silu)
    assert got.dtype == x.dtype and got.shape == x.shape

    def f(x, w, b, proj):
        f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
        gamma, beta = (f32(w), f32(b)) if affine else (jnp.ones((C,)), jnp.zeros((C,)))
        gamma, beta = jnp.broadcast_to(gamma, (B, C)), jnp.broadcast_to(beta, (B, C))
        if ss:
            s1 = 1.0 + f32(proj[:, :C])
            gamma, beta = gamma * s1, beta * s1 + f32(proj[:, C:])
        return _gn_ref(x.reshape(B, H * W, C), gamma, beta, num_groups=G, eps=eps, silu=silu).reshape(x.shape)

    _, want = jax.jvp(f, tuple(jops), tuple(jtans))
    _assert_tangent(got, want, dname)


def _route_case(route: str, dtype):
    """(Function call, plain call, primals, tangents); a parameter ``p``
    that requires grad enters through a product, as a module's weight."""
    rnd = np.random.RandomState(2)
    t = lambda *s: torch.as_tensor(_draw(rnd, *s)).to(dtype)  # noqa: E731
    if route == "attention":
        p = torch.as_tensor(_draw(rnd, 16)).requires_grad_()
        primals = (t(2, 2, 12, 16), t(2, 2, 12, 16), t(2, 2, 12, 8))
        fn = lambda q, k, v: attention.Attention.apply(0.25, 9, q * p.to(dtype), k, v)  # noqa: E731
        plain = lambda q, k, v: attention.attention_plain(q * p.to(dtype), k, v, scale=0.25, kv_len=9)  # noqa: E731
    else:
        p = (1 + 0.1 * torch.as_tensor(_draw(rnd, 32))).requires_grad_()
        primals = (t(2, 4, 8, 32) * 2 + 1, t(2, 64) * 0.3)

        def fn(x, proj):
            s, sh = proj.chunk(2, dim=-1)
            return groupnorm.GroupNorm.apply(8, 1e-6, True, x, p.to(dtype), None, s, sh)

        def plain(x, proj):
            s, sh = proj.chunk(2, dim=-1)
            return groupnorm.group_norm_plain(x, p.to(dtype), None, num_groups=8, eps=1e-6, scale=s, shift=sh,
                                              silu=True)
    return fn, plain, primals, tuple(t(*a.shape) for a in primals), p


@pytest.mark.parametrize("mode", ["torch.func.jvp", "forward_ad"])
@pytest.mark.parametrize("route", ["attention", "groupnorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_tangents_equal_the_plain_versions(monkeypatch, route, mode, dtype):
    _plain_launches(monkeypatch)
    fn, plain, primals, tangents, p = _route_case(route, dtype)
    want_out, want = torch.func.jvp(plain, primals, tangents)
    if mode == "torch.func.jvp":
        out, got = torch.func.jvp(fn, primals, tangents)
    else:
        with forward_ad.dual_level():
            out = fn(*(forward_ad.make_dual(a, d) for a, d in zip(primals, tangents)))
            out, got = forward_ad.unpack_dual(out)
    assert got is not None and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * float(want.abs().max()))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    # the loss on the primal back-propagates to the parameter as through the plain version
    g = torch.autograd.grad(out.float().square().sum(), p)[0]
    g_want = torch.autograd.grad(want_out.float().square().sum(), p)[0]
    torch.testing.assert_close(g, g_want, rtol=1e-6, atol=1e-6)


def test_has_tangent_sees_both_forward_modes():
    x = torch.randn(3)
    assert not loader.has_tangent(x, None)
    seen = []
    torch.func.jvp(lambda a: seen.append(loader.has_tangent(a)) or a * 2, (x,), (x,))
    with forward_ad.dual_level():
        seen.append(loader.has_tangent(None, forward_ad.make_dual(x, x)))
        seen.append(loader.has_tangent(x))
    assert seen == [True, True, False]


# ------------------------------------------------------------------ (b), (c)


def _flow_cfg(pair, amp: bool = False):
    cfg = copy.deepcopy(pair.tcfg)
    t = cfg.training
    t.lr, t.lr_warmup_steps, t.num_steps, t.ema_update_every = LR, WARMUP, NUM_STEPS, 1
    t.mixed_precision = "bf16" if amp else "no"
    return cfg


class FlowRun:
    """The reduced ``meanflow-nusc`` in both packages with shared weights,
    one batch, the JAX key chain's draws of step 0, the JAX step (loss and
    captured gradients) and the JAX loss and mse."""

    def __init__(self):
        self.pair = pair = UncondPair("meanflow-nusc", seed=0)
        rnd = np.random.RandomState(4)
        self.x = np.clip(0.5 * rnd.standard_normal((B, *RESOLUTION, 2)), -1, 1).astype(np.float32)
        key = jax.random.PRNGKey(7)
        rng_tr, rng_e = jax.random.split(jax.random.fold_in(key, 0))
        t, r = pair.jengine.sample_t_r(rng_tr, B)
        e = jax.random.normal(rng_e, self.x.shape, jnp.float32)
        self.draws = {k: torch.as_tensor(np.asarray(v)) for k, v in (("t", t), ("r", r), ("noise", e))}
        tx = optax.chain(_capture(), j_make_optimizer(lr=LR, warmup_steps=WARMUP, num_steps=NUM_STEPS))
        jstep = j_make_train_step(pair.jengine, tx, donate=False, loss_has_aux=True, ema_update_every=1,
                                  ema_update_after_step=WARMUP)
        jstate, jloss = jstep(JState.create(pair.params, tx), jnp.asarray(self.x), key)
        self.jloss = float(jloss)
        self.jgrads = _state_dicts(jstate.opt_state[0], {"model": pair.tmodel})
        self.jloss_mse = [float(v) for v in jax.jit(pair.jengine.loss)(pair.params, jax.random.fold_in(key, 0),
                                                                       jnp.asarray(self.x))]
        self.names = [f"model.{n}" for n, _ in pair.tmodel.named_parameters()]


@pytest.fixture(scope="module")
def run():
    return FlowRun()


def test_meanflow_loss_and_gradients_match_jax(run):
    engine = run.pair.tengine
    loss, mse = engine.loss(torch.as_tensor(run.x), **run.draws)
    assert loss.requires_grad and not mse.requires_grad
    assert float(loss) == pytest.approx(run.jloss_mse[0], rel=1e-5)
    assert float(mse) == pytest.approx(run.jloss_mse[1], rel=1e-5)
    params = list(run.pair.tmodel.parameters())
    _, grads = loss_and_grads(engine, params, torch.as_tensor(run.x), loss_has_aux=True, **run.draws)
    _assert_grads(dict(zip(run.names, grads)), run.jgrads)


@pytest.mark.parametrize("time_dist", ["lognorm", "uniform"])
def test_sample_t_r_orders_the_pair_and_ties_the_flow_ratio_share(time_dist):
    engine = MeanFlow(model=torch.nn.Identity(), sampling_shape=(2, 2, 1), time_dist=time_dist, flow_ratio=0.25)
    t, r = engine.sample_t_r(64, torch.Generator().manual_seed(3))
    assert t.shape == r.shape == (64,) and bool((r <= t).all()) and bool(((t > 0) & (t < 1)).all())
    assert int((r == t).sum()) == 16  # int(0.25 · 64) samples get r = t
    t2, r2 = engine.sample_t_r(64, torch.Generator().manual_seed(3))
    assert torch.equal(t, t2) and torch.equal(r, r2)
    with pytest.raises(ValueError):
        dataclasses.replace(engine, time_dist="beta").sample_t_r(4)


def test_loss_draws_t_r_then_the_noise_from_the_generator(run):
    engine = run.pair.tengine
    x = torch.as_tensor(run.x)
    gen = torch.Generator().manual_seed(5)
    t, r = engine.sample_t_r(B, gen)
    noise = torch.randn(x.shape, generator=gen)
    with torch.no_grad():
        want = engine.loss(x, t=t, r=r, noise=noise)
        got = engine.loss(x, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _trainer(pair, amp: bool, tmp_path) -> FlowTrainer:
    """A ``FlowTrainer`` on the CPU holding the pair's weights."""
    from lidarcrafter_tpu_torch.weights import load_flax_params

    trainer = FlowTrainer(_flow_cfg(pair, amp), iter(()), output_dir=tmp_path, log_fn=None, device="cpu")
    load_flax_params(trainer.models["model"], pair.params)
    return trainer


def test_flow_trainer_step_matches_jax(run, tmp_path, monkeypatch):
    trainer = _trainer(run.pair, False, tmp_path)
    state = TrainState.create(trainer.models, trainer.optimizer)
    grads, update = {}, AdamW.update_

    def capture(self, params, step_grads, opt_state):  # the step's gradients, before the clip scales them
        grads.update((n, g.clone()) for n, g in zip(run.names, step_grads))
        update(self, params, step_grads, opt_state)

    monkeypatch.setattr(AdamW, "update_", capture)
    state, loss = trainer.step_fn(state, trainer.prepare_batch({"x_0": torch.as_tensor(run.x)}), 0, **run.draws)
    assert state.step == 1 and float(loss) == pytest.approx(run.jloss, rel=1e-5)
    _assert_grads(grads, run.jgrads)


def test_amp_flow_step_matches_jax_amp(run):
    """bf16 AMP against the JAX package's ``amp_engine`` on the same
    weights, batch and draws: the loss to 5e-2 relative; the port's AMP
    gradients to the JAX float32 ones to 5e-2 relative L2, and no farther
    from them than JAX's own AMP gradients (XLA:CPU sums bf16 products in
    bf16)."""
    pair = run.pair
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    engine = j_amp_engine(pair.jengine)
    (j_amp_loss, _), grads = jax.jit(jax.value_and_grad(lambda p: engine.loss(p, key, jnp.asarray(run.x)),
                                                        has_aux=True))(pair.params)
    j_amp = _state_dicts(grads, {"model": pair.tmodel})
    params = list(pair.tmodel.parameters())
    t_loss, t_amp = loss_and_grads(amp_engine(pair.tengine), params, torch.as_tensor(run.x), loss_has_aux=True,
                                   **run.draws)
    t_amp = dict(zip(run.names, t_amp))
    assert all(g.dtype == torch.float32 for g in t_amp.values())  # master gradients
    assert float(t_loss) == pytest.approx(float(j_amp_loss), rel=5e-2)

    def rel(a, b):
        return np.sqrt(sum(float((a[n] - b[n]).norm()) ** 2 for n in b) / sum(float(b[n].norm()) ** 2 for n in b))

    port_err, jax_err = rel(t_amp, run.jgrads), rel(j_amp, run.jgrads)
    assert port_err <= 5e-2
    assert port_err <= jax_err, (port_err, jax_err)


# ------------------------------------------------------------------ (d)


def test_train_cli_flow_two_steps_and_its_checkpoint_serves(tmp_path, capsys):
    out = tmp_path / "run"
    small = ["--resolution", *map(str, RESOLUTION), "--model-channels", "16"]
    train_cli.main(["-c", "meanflow-nusc", "--synthetic-data", "--num-steps", "2", "--device", "cpu", "-b", "1",
                    "--checkpoint-every", "2", "--output-dir", str(out), *small])
    assert "'step': 2" in capsys.readouterr().out
    path = latest_checkpoint(out)
    assert path.endswith("ckpt_0000000002")
    saved = torch.load(f"{path}/state.pt", weights_only=True)
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("meanflow-nusc"), resolution=RESOLUTION, model_channels=16)
    assert cfg.model.params["base_channels"] == 16
    for ema, key in ((True, "ema"), (False, "models")):
        gen = generate_flow.FlowFrameGenerator(cfg, "cpu", ckpt=path, ema=ema)
        for name, value in gen.model.state_dict().items():
            assert torch.equal(value, saved[key]["model"][name]), name
    assert not all(torch.equal(saved["ema"]["model"][n], v) for n, v in saved["models"]["model"].items())
    generate_flow.main(["--ckpt", path, "--ema", "-n", "1", "--device", "cpu", "-o", str(tmp_path / "f"), *small])
    depth = np.load(tmp_path / "f" / "flow_sample_0000_depth.npy")
    assert depth.shape == (*RESOLUTION, 1) and np.isfinite(depth).all()
