"""Serving export: the three kernels as ``torch.library`` operators and the
sampler traced with ``torch.export`` (``lidarcrafter_tpu_torch/serving``),
against the eager port sampler and the JAX package's sampler, at reduced
size on the CPU.

On the CPU each operator runs the kernel's plain version, so an artifact
replays the eager sampler bit for bit: the same ops on the same draws.
Against JAX the exported DDIM program is held, on the JAX sampler's x_T and
weights, to the limits ``test_torch_port_uncond_sampler.py`` holds the
eager sampler to (1e-4 relative in the L2 norm, 1e-2 of the largest value
entry by entry): the first step divides by α(t=1) = 5.5e-4, so one f32
rounding of the denoiser output becomes ~3e-3 in an entry (measured 3.2e-3
of the largest; 3.4e-5 in L2).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_harness import RESOLUTION, UncondPair, one_torch_thread, shrink  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import export as export_cli
from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca
from lidarcrafter_tpu_torch.serving import export_sampler, load_artifact, save_artifact
from lidarcrafter_tpu_torch.serving.export import draw_inputs
from lidarcrafter_tpu_torch.training.factory import layout_condition_batch, make_lidar_utils
from lidarcrafter_tpu_torch.training.preprocess import postprocess_sample

REPO = Path(__file__).resolve().parent.parent
B, STEPS = 2, 2
L2_RTOL, ENTRY_RTOL = 1e-4, 1e-2


def _draw(*shape, seed=0, dtype=torch.float32):
    return torch.as_tensor(np.random.RandomState(seed).standard_normal(shape).astype(np.float32)).to(dtype)


def _op_cases():
    for dtype in (torch.float32, torch.bfloat16):
        d = dict(dtype=dtype)
        oaca_ops = (_draw(2, 2, 24, 32, **d), _draw(2, 2, 24, 32, seed=1, **d), _draw(2, 2, 24, 32, seed=2, **d),
                    _draw(2, 2, 5, 64, seed=3, **d), _draw(2, 2, 24, 32, seed=4, **d), _draw(2, 2, 5, 32, seed=5, **d))
        yield f"oaca-{dtype}", torch.ops.lidarcrafter_torch.oaca_forward.default, (*oaca_ops, 0.35)
        qkv = (_draw(2, 2, 24, 32, **d), _draw(2, 2, 27, 32, seed=1, **d), _draw(2, 2, 27, 16, seed=2, **d))
        yield f"attention-{dtype}", torch.ops.lidarcrafter_torch.attention_forward.default, (*qkv, 0.25, 24)
        s, t = _draw(2, 64, seed=3, **d).chunk(2, dim=-1)  # strided views, as a projection's halves
        gn = (_draw(2, 4, 8, 32, **d), _draw(32, seed=1), _draw(32, seed=2), s, t, 8, 1e-6, True)
        yield f"group_norm-{dtype}", torch.ops.lidarcrafter_torch.group_norm.default, gn
        yield f"group_norm-none-{dtype}", torch.ops.lidarcrafter_torch.group_norm.default, (
            gn[0], None, None, None, None, 4, 1e-5, False)


OP_CASES = list(_op_cases())


@pytest.mark.parametrize("op,args", [c[1:] for c in OP_CASES], ids=[c[0] for c in OP_CASES])
def test_operator_passes_opcheck(op, args):
    """Schema, fake rule (shape, dtype and the kernel's strides), autograd
    registration and AOT dispatch, on CPU tensors."""
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket._qualified_op_name))
        return func(*args, **(kwargs or {}))


class _Call(torch.nn.Module):
    def __init__(self, call, consts):
        super().__init__()
        self.call, self.consts = call, consts

    def forward(self, *tensors):
        return self.call(*tensors, *self.consts)


@pytest.mark.parametrize("name", ["oaca", "attention", "group_norm"])
def test_wrappers_serve_through_the_operator_and_train_through_the_plain_version(name):
    """Traced by ``torch.export`` with grad off, the wrapper is one call of
    its operator, and the exported graph's output equals the plain
    version's bit for bit in the kernel's layout.  An eager call with grad
    off runs the plain version with no dispatcher in between (on the card:
    a direct launch); with an operand that requires grad, the plain version
    under autograd, no operator."""
    args = {c[0].split("-")[0]: c[2] for c in OP_CASES if c[0].endswith("float32")}[name]
    if name == "oaca":
        call = lambda *a: oaca.oaca_attention(*a[:6], scale=a[6])  # noqa: E731
        plain = lambda *a: oaca.oaca_attention_plain(*a[:6], scale=a[6])  # noqa: E731
    elif name == "attention":
        call = lambda *a: attention.attention(*a[:3], scale=a[3], kv_len=a[4])  # noqa: E731
        plain = lambda *a: attention.attention_plain(*a[:3], scale=a[3], kv_len=a[4])  # noqa: E731
    else:
        def call(x, w, b, s, t, g, eps, silu):
            return groupnorm.group_norm(x, w, b, num_groups=g, eps=eps, scale=s, shift=t, silu=silu)

        def plain(x, w, b, s, t, g, eps, silu):
            return groupnorm.group_norm_plain(x, w, b, num_groups=g, eps=eps, scale=s, shift=t, silu=silu)
    op = f"lidarcrafter_torch.{name}" + ("" if name == "group_norm" else "_forward")
    n = sum(isinstance(a, torch.Tensor) for a in args)
    tensors, consts = args[:n], args[n:]
    want = plain(*args)
    with torch.no_grad():
        exported = torch.export.export(_Call(call, consts), tuple(tensors))
        out = exported.module()(*tensors)
    assert [str(node.target) for node in exported.graph.nodes].count(f"{op}.default") == 1
    assert torch.equal(out, want)
    if name != "group_norm":  # the kernel writes (B, Lq, heads, d)
        assert out.transpose(1, 2).is_contiguous()
    rec = _Ops()
    with torch.no_grad(), rec:
        out = call(*args)
    assert torch.equal(out, want)
    assert not any(o.startswith("lidarcrafter_torch") for o in rec.ops)
    x = args[0].clone().requires_grad_()
    rec = _Ops()
    with rec:
        y = call(x, *args[1:])
    assert not any(o.startswith("lidarcrafter_torch") for o in rec.ops)
    y.float().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.fixture(scope="module")
def uncond():
    pair = UncondPair("nuscenes-unet-uncond")
    pair.tlu = make_lidar_utils(pair.tcfg)
    return pair


def _meta(engine, mode, conditional, steps=STEPS):
    return {"config": "test", "batch_size": B, "num_steps": steps, "mode": mode,
            "sampling_shape": list(engine.sampling_shape), "conditional": conditional}


@pytest.fixture(scope="module")
def uncond_artifact(tmp_path_factory, uncond):
    """The uncond engine at the harness's reduced size with the JAX
    weights (``UncondPair``) and its DDIM@2 artifact, B = 2, exported on
    the CPU."""
    exported = export_sampler(uncond.tengine, uncond.tlu, batch_size=B, num_steps=STEPS, mode="ddim")
    art = save_artifact(tmp_path_factory.mktemp("art") / "uncond", exported, _meta(uncond.tengine, "ddim", False))
    return art, exported


def _eager(uncond, seed, mode="ddim", batch=B, steps=STEPS):
    """The eager port sampler's frames for ``seed``, as a generator draws them."""
    sample = uncond.tengine.sample(batch, steps, mode=mode, generator=torch.Generator().manual_seed(seed))
    return postprocess_sample(sample, uncond.tlu)


def test_uncond_artifact_replays_the_eager_sampler(uncond, uncond_artifact):
    art, _ = uncond_artifact
    fn, meta = load_artifact(art, device="cpu")
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    got, want = fn(3), _eager(uncond, 3)
    assert set(got) == set(want) == {"depth", "xyz", "reflectance"}
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(fn(4)["depth"], got["depth"])
    names = {str(n.target) for n in uncond_artifact[1].graph.nodes}
    assert {"lidarcrafter_torch.group_norm.default", "lidarcrafter_torch.attention_forward.default"} <= names


def test_artifact_loads_in_a_fresh_process_without_model_code(uncond, uncond_artifact):
    """A new interpreter loads and calls the artifact importing only the
    serving module and the kernels' operator registrations."""
    art, _ = uncond_artifact
    want = _eager(uncond, 7)["depth"]
    out = art.parent / "depth.pt"
    code = (
        "import sys, torch\n"
        "from lidarcrafter_tpu_torch.serving import load_artifact\n"
        f"fn, meta = load_artifact({str(art)!r}, device='cpu')\n"
        f"torch.save(fn(7)['depth'], {str(out)!r})\n"
        "bad = [m for m in sys.modules if m.startswith(('lidarcrafter_tpu_torch.models', "
        "'lidarcrafter_tpu_torch.diffusion', 'lidarcrafter_tpu_torch.training', 'lidarcrafter_tpu_torch.configs', "
        "'jax', 'lidarcrafter_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300, env=env)
    assert torch.equal(torch.load(out), want)


def test_exported_ddim_matches_jax_on_the_same_x_T(uncond, uncond_artifact):
    """The exported program (the one the round trip above saved and
    replayed) on the JAX sampler's x_T: the eager port sampler's frames on
    it exactly, and the JAX sampler's sample within the eager sampler's
    limits."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(uncond.jengine.sample(uncond.params, key, batch_size=B, num_steps=STEPS, mode="ddim"))
    x_T = torch.as_tensor(np.array(jax.random.normal(jax.random.split(key)[0], (B, *uncond.jengine.sampling_shape),
                                                     jnp.float32)))
    program = uncond_artifact[1].module()
    with torch.no_grad():
        got = program(x_T=x_T)
    eager = uncond.tengine.sample(B, STEPS, mode="ddim", x_T=x_T)
    for k, v in postprocess_sample(eager, uncond.tlu).items():
        assert torch.equal(got[k], v), k
    eager = eager.numpy()
    assert eager.shape == want.shape == (B, *RESOLUTION, 2)
    err = eager - want
    assert np.linalg.norm(err) <= L2_RTOL * np.linalg.norm(want)
    assert np.abs(err).max() <= ENTRY_RTOL * np.abs(want).max()


def test_ddpm_through_the_noise_stack_equals_eager_ddpm(uncond):
    """DDPM@1, B = 1: the program on ``draw_inputs``' x_T and noise stack
    for a seed (what ``load_artifact``'s ``fn`` feeds it; the round trip
    through the files is the tests' above) equals eager DDPM."""
    exported = export_sampler(uncond.tengine, uncond.tlu, batch_size=1, num_steps=1, mode="ddpm")
    inputs = draw_inputs(uncond.tengine.sampling_shape, 1, 1, "ddpm", 11)
    with torch.no_grad():
        got = exported.module()(**inputs)
    want = _eager(uncond, 11, "ddpm", batch=1, steps=1)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    placeholders = [n.name for n in exported.graph.nodes if n.op == "placeholder"]
    assert any("noise" in n for n in placeholders)


@pytest.fixture(scope="module")
def v6():
    cfg = shrink(tcfgs, "nuscenes-box-layout-v6", small=True)
    return cfg, CondFrameGenerator(cfg, device="cpu")


def test_cond_artifact_takes_the_condition_at_run_time(v6, tmp_path):
    """The v6 stack (reduced) exported with DPM++(2M)@1: the condition is
    an input, not a constant: the artifact replays the eager generator for
    a given condition and seed, and another seed or another condition
    changes its frames (the port's seeded weights have no zero
    ``proj_out``)."""
    cfg, gen = v6
    batch = layout_condition_batch(cfg, B, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="condition_example"):
        export_sampler(gen.engine, gen.lidar_utils, batch_size=B, num_steps=STEPS)
    exported = export_sampler(gen.engine, gen.lidar_utils, batch_size=B, num_steps=1, mode="dpmpp_2m",
                              with_postprocess=False, condition_example=batch)
    fn, meta = load_artifact(save_artifact(tmp_path / "v6", exported, _meta(gen.engine, "dpmpp_2m", True, 1)), device="cpu")
    with pytest.raises(ValueError, match="condition"):
        fn(5)
    got = fn(5, batch)
    want, _ = gen.generate(B, 1, mode="dpmpp_2m", seed=5, batch=batch)
    assert got.shape == (B, *cfg.data.resolution, 2)
    assert torch.equal(got, want)
    assert (fn(6, batch) - got).abs().max() > 0
    other = layout_condition_batch(cfg, B, generator=torch.Generator().manual_seed(1))
    assert (fn(5, other) - got).abs().max() > 0
    names = [str(n.target) for n in exported.graph.nodes]
    assert names.count("lidarcrafter_torch.oaca_forward.default") > 0


def test_export_cli_writes_an_artifact_that_replays_the_generator(uncond, tmp_path, capsys):
    """The CLI at its default bfloat16 serving dtype (float32 artifacts:
    the tests above)."""
    out, dtype = tmp_path / "art", "bfloat16"
    export_cli.main(["-c", "nuscenes-unet-uncond", "-o", str(out), "--batch", "1", "--num-steps", "1",
                     "--mode", "dpmpp_2m", "--resolution", *map(str, RESOLUTION), "--model-channels", "16",
                     "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("exported nuscenes-unet-uncond") and "MB" in line
    fn, meta = load_artifact(out, device="cpu")
    assert meta["dtype"] == dtype and meta["batch_size"] == 1 and meta["postprocess"]
    got = fn(2)
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-unet-uncond"), resolution=RESOLUTION,
                                       model_channels=16)
    gen = UncondFrameGenerator(cfg, device="cpu", dtype=getattr(torch, dtype))
    want = gen.generate(1, 1, mode="dpmpp_2m", seed=2)[1]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_export_leaves_the_engines_weights_trainable(uncond, uncond_artifact):
    """Tracing turns ``requires_grad`` off on the engine's weights while it
    runs and restores it: a trainer sharing them keeps training them."""
    assert all(p.requires_grad for p in uncond.tengine.model.parameters())
