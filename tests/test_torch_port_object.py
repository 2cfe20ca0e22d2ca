"""The box → object-points branch of the PyTorch port against the JAX
package, on the CPU: ``nuscenes-object`` at its published widths
(``PointUNet`` 4 → 128 … 512 … 4 with a 768 + 3 condition,
``ObjectGenEncoder``) over clouds of 64 points instead of 1024 (every layer
is pointwise, so the count changes no width), 6 objects of 2 synthetic
scenes.  Weights are numpy-seeded for every flax leaf and go to the port
through its weight bridge.

Limits (``PERF.md`` §2): the denoiser and encoder 1e-4 of max(1, the
largest output), the DDIM@5 sample with the JAX x_T injected 1e-4 relative
L2, the box codecs exactly.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.datasets import transforms as JT
from lidarcrafter_tpu.training.factory import build_object_training as jax_build
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import generate_object
from lidarcrafter_tpu_torch.datasets import transforms as TT
from lidarcrafter_tpu_torch.training.factory import build_object_training as torch_build
from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes
from lidarcrafter_tpu_torch.weights import load_flax_params

POINTS, STEPS = 64, 5
NET_TOL, SAMPLER_L2 = 1e-4, 1e-4


def small(configs):
    cfg = configs.get_config("nuscenes-object")
    cfg.data.num_samples = POINTS
    return cfg


class Stack:
    """``nuscenes-object`` built by both packages with shared random
    weights, and one request."""

    def __init__(self):
        jmodels, jengine, _ = jax_build(small(jcfgs))
        self.jengine = dataclasses.replace(jengine, apply_fn=jax.jit(jengine.apply_fn),
                                           cond_apply_fn=jax.jit(jengine.cond_apply_fn))
        self.tmodels, self.tengine, _ = torch_build(small(tcfgs), device="cpu")
        self.boxes = synthetic_object_boxes(2, 3, seed=4)
        self.B = len(self.boxes["fg_class"])
        self.jinput = {k: jnp.asarray(v) for k, v in self.boxes.items()}
        self.tinput = {k: torch.as_tensor(v) for k, v in self.boxes.items()}
        cond = random_params(jax.eval_shape(jmodels["cond"].init, jax.random.PRNGKey(0), self.jinput), 1)
        feat = jax.eval_shape(jmodels["cond"].apply, cond, self.jinput)
        cd = {"time_condition": jnp.zeros((self.B,)), "other_condition": feat}
        model = random_params(jax.eval_shape(jmodels["model"].init, jax.random.PRNGKey(0),
                                             jnp.zeros((self.B, POINTS, 4)), cd), 2)
        self.params = {"model": model, "cond": cond}
        for k in ("model", "cond"):
            load_flax_params(self.tmodels[k], self.params[k])


@pytest.fixture(scope="module")
def stack():
    return Stack()


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def test_encoder_and_point_unet_match_jax(stack):
    rnd = np.random.RandomState(3)
    x = rnd.uniform(-1, 1, (stack.B, POINTS, 4)).astype(np.float32)
    log_snr = rnd.uniform(-6, 6, stack.B).astype(np.float32)
    feat = stack.jengine.cond_apply_fn(stack.params, stack.jinput)
    want = stack.jengine.apply_fn(stack.params, jnp.asarray(x),
                                  {"time_condition": jnp.asarray(log_snr), "other_condition": feat})
    with torch.no_grad():
        tfeat = stack.tmodels["cond"](stack.tinput)
        got = stack.tmodels["model"](torch.as_tensor(x), {"time_condition": torch.as_tensor(log_snr),
                                                          "other_condition": tfeat})
    assert tfeat.shape == (stack.B, 768)
    close(tfeat, feat, NET_TOL)
    close(got, want, NET_TOL)
    assert float(np.abs(np.asarray(want) - x).max()) > 0.1  # the residual branch is not ~0


def test_ddim_sample_with_the_jax_x_T_matches_jax(stack):
    key = jax.random.PRNGKey(5)
    want = np.asarray(stack.jengine.sample(stack.params, key, stack.jinput, batch_size=stack.B, num_steps=STEPS,
                                           mode="ddim"))
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[0], (stack.B, POINTS, 4), jnp.float32))
    got = stack.tengine.sample(stack.tinput, batch_size=stack.B, num_steps=STEPS, mode="ddim",
                               x_T=torch.as_tensor(x_T)).numpy()
    assert got.shape == want.shape == (stack.B, POINTS, 4) and np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= SAMPLER_L2 * np.linalg.norm(want)
    # the start noise matters (the untrained denoiser's x̂_0 dominates the
    # sample: another x_T moves it by ~0.2%)
    other = stack.tengine.sample(stack.tinput, batch_size=stack.B, num_steps=STEPS, mode="ddim",
                                 x_T=torch.as_tensor(x_T) * 0.5).numpy()
    assert np.linalg.norm(other - want) > 10 * SAMPLER_L2 * np.linalg.norm(want)


def test_object_codecs_match_jax_exactly():
    rnd = np.random.RandomState(7)
    for _ in range(20):
        box = np.concatenate([rnd.uniform(-60, 60, 3), rnd.uniform(0.5, 8, 3), rnd.uniform(-3, 3, 1)])
        np.testing.assert_array_equal(TT.object_encoding_boxes_3d(box), JT.object_encoding_boxes_3d(box))
        pts = rnd.uniform(-1, 1, (50, 4))
        np.testing.assert_array_equal(TT.unnorm_fg_points(pts, box), JT.unnorm_fg_points(pts, box))
    boxes = synthetic_object_boxes(2, 3, seed=4)
    assert boxes["fg_encoding_box"].shape == (6, 6) and boxes["fg_text_features"].shape == (9, 512)
    assert boxes["fg_class"].min() >= 0 and boxes["fg_class"].max() < 8


def test_generator_raises_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = small(tcfgs)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_object.ObjectGenerator(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_object.main(["--synthetic", "1"])
    assert generate_object.ObjectGenerator(cfg, device="cpu").device.type == "cpu"


def test_cli_writes_the_jax_tools_pickle(tmp_path):
    boxes = tmp_path / "boxes.pkl"
    with open(boxes, "wb") as f:
        pickle.dump(synthetic_object_boxes(1, 2, seed=0), f)
    for source, n in ((["--synthetic", "1", "--objects", "3"], 3), (["--boxes", str(boxes)], 2)):
        out = tmp_path / "objects.pkl"
        generate_object.main([*source, "--num-steps", "2", "--mode", "ddim", "--device", "cpu", "-o", str(out)])
        with open(out, "rb") as f:
            clouds = pickle.load(f)
        assert isinstance(clouds, np.ndarray) and clouds.shape == (n, 1024, 4) and np.isfinite(clouds).all()
    # --ckpt reads a train.py checkpoint (test_torch_port_branch_train.py serves one)
    with pytest.raises(FileNotFoundError):
        generate_object.main(["--synthetic", "1", "--ckpt", str(tmp_path / "no_such_ckpt"), "--device", "cpu"])
