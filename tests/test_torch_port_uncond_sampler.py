"""Unconditional sampling: the PyTorch port against the JAX package, with
shared weights and start noise, at reduced size, and the port's two
unconditional entry points on the CPU.

x_T is drawn from the JAX key exactly as ``ContinuousDiffusion.sample``
draws it (``split(rng)[0]``) and handed to the port; MeanFlow's z is drawn
from the key itself, as ``MeanFlow.sample`` does.  DDIM (η=0),
DPM-Solver++(2M) and MeanFlow are deterministic after that; DDPM draws fresh
noise every step, which no two frameworks share, so it is checked for shape,
finiteness and its generator only.

Tolerance, as in ``test_torch_port_sampler.py``: the first step predicts
x̂_0 = (x_T − σ·ε̂)/α at t = 1 with α = 5.5e-4, so one f32 rounding of the
denoiser output becomes ~4e-3 in each x̂_0 entry that the clip to [-1, 1]
does not reach.  The diffusion samples are held to 1e-4 relative in the L2
norm and to 1e-2 of their largest value entry by entry.  The MeanFlow sample
is one UNet call away from z: 1e-4 of its largest value, as the UNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import RESOLUTION, UncondPair, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
from lidarcrafter_tpu_torch.generate import main as generate_main
from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
from lidarcrafter_tpu_torch.generate_flow import main as generate_flow_main

L2_RTOL = 1e-4
ENTRY_RTOL = 1e-2
FLOW_RTOL = 1e-4
STEPS = 3
B = 2


@pytest.fixture(scope="module")
def uncond():
    return UncondPair("nuscenes-unet-uncond")


@pytest.fixture(scope="module")
def flow():
    return UncondPair("meanflow-nusc")


@pytest.mark.parametrize("mode", ["ddim", "dpmpp_2m"])
def test_sample_matches_jax_with_injected_x_T(uncond, mode):
    key = jax.random.PRNGKey(3)
    want = np.asarray(uncond.jengine.sample(uncond.params, key, batch_size=B, num_steps=STEPS, mode=mode))
    rng_init, _ = jax.random.split(key)  # as ContinuousDiffusion.sample
    x_T = np.array(jax.random.normal(rng_init, (B, *uncond.jengine.sampling_shape), jnp.float32))
    got = uncond.tengine.sample(B, STEPS, mode=mode, x_T=torch.as_tensor(x_T)).numpy()
    assert got.shape == want.shape == (B, *RESOLUTION, 2)
    assert np.all(np.isfinite(got))
    err = got - want
    assert np.linalg.norm(err) <= L2_RTOL * np.linalg.norm(want)
    assert np.abs(err).max() <= ENTRY_RTOL * np.abs(want).max()
    # the start noise matters: another x_T gives another sample
    other = uncond.tengine.sample(B, STEPS, mode=mode, x_T=torch.as_tensor(x_T) * 0.5).numpy()
    assert np.linalg.norm(other - want) > 100 * L2_RTOL * np.linalg.norm(want)


def test_ddpm_runs_from_its_generator(uncond):
    def draw(seed):
        return uncond.tengine.sample(B, STEPS, mode="ddpm", generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (B, *RESOLUTION, 2) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_meanflow_one_step_matches_jax_with_injected_z(flow):
    key = jax.random.PRNGKey(5)
    want = np.asarray(flow.jengine.sample(flow.params, key, batch_size=B))
    z = np.array(jax.random.normal(key, (B, *flow.jengine.sampling_shape), jnp.float32))
    got = flow.tengine.sample(B, z=torch.as_tensor(z)).numpy()
    assert got.shape == want.shape == (B, *RESOLUTION, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_RTOL * np.abs(want).max())
    assert np.abs(got - z).max() > 1e-2  # the model's velocity is not zero


def test_generators_answer_requests_on_the_cpu():
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("nuscenes-unet-uncond"), resolution=RESOLUTION)
    gen = UncondFrameGenerator(cfg, device="cpu", weights_seed=1)
    sample, post = gen.generate(B, 2, mode="dpmpp_2m", seed=4)
    again, _ = gen.generate(B, 2, mode="dpmpp_2m", seed=4)
    torch.testing.assert_close(sample, again, rtol=0, atol=0)
    assert sample.shape == (B, *RESOLUTION, 2) and post["xyz"].shape == (B, *RESOLUTION, 3)
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config("meanflow-nusc"), resolution=RESOLUTION)
    sample, post = FlowFrameGenerator(cfg, device="cpu").generate(B, seed=4)
    assert sample.abs().max() <= 1.0 and torch.isfinite(post["depth"]).all()


def test_uncond_entry_points_raise_without_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_main(["-n", "1", "--num-steps", "1", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_flow_main(["-n", "1", "-o", str(tmp_path)])
    # asked for explicitly, the CPU runs the plain path end to end at full width
    generate_main(["-n", "1", "--num-steps", "2", "--mode", "ddim", "--resolution", *map(str, RESOLUTION),
                   "--device", "cpu", "-o", str(tmp_path / "uncond")])
    samples = np.load(tmp_path / "uncond" / "samples.npy")
    assert samples.shape == (1, *RESOLUTION, 2) and np.all(np.isfinite(samples))
    assert np.loadtxt(tmp_path / "uncond" / "sample_0000.txt").shape[-1] == 4
    generate_flow_main(["-n", "1", "--resolution", *map(str, RESOLUTION), "--device", "cpu",
                        "-o", str(tmp_path / "flow")])
    depth = np.load(tmp_path / "flow" / "flow_sample_0000_depth.npy")
    assert depth.shape == (*RESOLUTION, 1) and np.all(np.isfinite(depth))
