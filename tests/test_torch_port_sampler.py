"""Conditional sampling: the PyTorch port against the JAX package, with
shared weights, conditions and start noise, at reduced size.

x_T is drawn from the JAX key exactly as ``CondContinuousDiffusion.sample``
draws it and handed to the port.  DDIM (η=0) and DPM-Solver++(2M) are
deterministic after that.

Tolerance.  The first step predicts x̂_0 = (x_T − σ·ε̂)/α at t = 1, where
α = 5.5e-4: a difference of one f32 rounding in the denoiser output (~2e-6
between the two frameworks, see ``test_torch_port_model.py``) becomes ~4e-3
in each x̂_0 entry that the clip to [-1, 1] does not reach (with random
weights about 5 entries in 16384).  So the sample is held to 1e-4 relative
in the L2 norm, and to 1e-2 of its largest value entry by entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import Pair, one_torch_thread, to_torch  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu_torch.diffusion.continuous import lambda_spaced_timesteps
from lidarcrafter_tpu_torch.diffusion.schedules import get_log_snr_fn

L2_RTOL = 1e-4
ENTRY_RTOL = 1e-2
STEPS = 3


@pytest.fixture(scope="module")
def pair():
    return Pair("nuscenes-box-layout-v6", small=True)


@pytest.mark.parametrize("mode", ["ddim", "dpmpp_2m"])
def test_sample_matches_jax_with_injected_x_T(pair, mode):
    B = pair.batch["is_valid_obj"].shape[0]
    key = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    want = np.asarray(pair.jengine.sample(
        pair.params, key, jbatch, batch_size=B, num_steps=STEPS, mode=mode
    ))
    rng_init, _ = jax.random.split(key)  # as CondContinuousDiffusion.sample
    x_T = np.asarray(jax.random.normal(rng_init, (B, *pair.jengine.sampling_shape), jnp.float32))
    got = pair.tengine.sample(
        to_torch(pair.batch), batch_size=B, num_steps=STEPS, mode=mode,
        x_T=torch.as_tensor(x_T),
    ).numpy()
    assert got.shape == want.shape == (B, 32, 128, 2)
    assert np.all(np.isfinite(got))
    err = got - want
    assert np.linalg.norm(err) <= L2_RTOL * np.linalg.norm(want)
    assert np.abs(err).max() <= ENTRY_RTOL * np.abs(want).max()
    # the start noise matters: another x_T gives another sample
    other = pair.tengine.sample(
        to_torch(pair.batch), batch_size=B, num_steps=STEPS, mode=mode,
        x_T=torch.as_tensor(x_T) * 0.5,
    ).numpy()
    assert np.linalg.norm(other - want) > 100 * L2_RTOL * np.linalg.norm(want)


@pytest.mark.parametrize("num_steps", [3, 15])
def test_lambda_grid_matches_jax(num_steps):
    from lidarcrafter_tpu.diffusion import schedules as jsched
    from lidarcrafter_tpu.diffusion.continuous import lambda_spaced_timesteps as jgrid

    want = np.asarray(jgrid(jsched.get_log_snr_fn("cosine"), num_steps))
    got = lambda_spaced_timesteps(get_log_snr_fn("cosine"), num_steps).numpy()
    # the JAX grid interpolates in f32, the port in f64 of the same f32 table
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0] == 1.0 and got[-1] == 0.0
