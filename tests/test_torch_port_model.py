"""Condition encoder + ``LayoutUnetV1`` forward: the PyTorch port against
the JAX package, with shared weights and inputs, at reduced size.

Tolerance: the whole stack in float32 runs ~60 convolutions, matmuls and
norms whose sums are taken in another order by the two frameworks; each
adds a few f32 ulps, so the output is held to 1e-4 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import Pair, one_torch_thread, to_torch  # noqa: F401 (one_torch_thread: autouse)

STACK_RTOL = 1e-4


@pytest.mark.parametrize(
    "name,small",
    [("nuscenes-box-layout-v6", False), ("nuscenes-auto-reg-v2", True)],
)
def test_encoder_and_unet_forward_match_jax(name, small):
    pair = Pair(name, small=small)
    B = pair.batch["is_valid_obj"].shape[0]
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    tbatch = to_torch(pair.batch)

    jlayout = jax.jit(pair.jmodels["cond"].apply)(pair.params["cond"], jbatch)
    with torch.no_grad():
        tlayout = pair.tmodels["cond"](tbatch)
    assert set(tlayout) == set(jlayout)
    for k in jlayout:
        want = np.asarray(jlayout[k])
        got = tlayout[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=k)

    rnd = np.random.RandomState(7)
    x = rnd.standard_normal((B, *pair.jcfg.data.resolution, 2)).astype(np.float32)
    t = np.array([-3.0, 5.0], np.float32)  # log-SNR time condition
    want = np.asarray(jax.jit(pair.jmodels["model"].apply)(
        pair.params["model"], jnp.asarray(x),
        {"time_condition": jnp.asarray(t), "other_condition": jlayout},
    ))
    with torch.no_grad():
        got = pair.tmodels["model"](
            torch.as_tensor(x), {"time_condition": torch.as_tensor(t), "other_condition": tlayout}
        ).numpy()
    assert got.shape == want.shape == (B, *pair.jcfg.data.resolution, 2)
    scale = np.abs(want).max()
    assert scale > 1e-2  # random weights, no zero-initialised output layer
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_RTOL * scale)
