"""The 4D rollout of the PyTorch port against the JAX package's
``TemporalRollout`` at reduced size (32x128, ``small`` stacks of
``nuscenes-box-layout-v6`` and ``nuscenes-auto-reg-v2`` with shared random
weights), S = 2 scenes, 1 + 2 frames, DDIM (η = 0) at 5 steps and
DPM-Solver++(2M) at 15.  Every frame's x_T is drawn from the JAX package's key chain
(``temporal.py:289-298``, ``conditional.py:185-186``) and injected.

(a) The port's per-frame geometry step fed the JAX package's own previous
    frame gives the JAX body's conditions (``temporal.py:106-125``,
    composed here) to 1e-5 of max(1, max |JAX|) on at least 99.9% of the
    pixels; the rest are bin-edge flips (a point within an ulp of a pixel
    edge), counted and printed.
(b) Free-running: frame 0 within 1e-4 relative in L2 (as the sampler
    tests).  Each later frame is held to the reference on the port's own
    trajectory: the JAX body's geometry on the port's previous frame gives
    the port's conditions but for at most 0.1% of the pixels, and the JAX
    sampler on the port's conditions (same key) gives the port's frame to
    1e-3 relative in L2.  The distance to the JAX package's own
    free-running frames is printed, not held: frame 0's ~1e-5 flips tens
    to hundreds of condition pixels (generated points lie on pixel edges),
    and one flipped pixel changes the next frame by about 1%, in either
    package.
(c) ``stream_chunks`` 1 and 2, and ``fetch`` on and off, give the same
    frames.
(d) The CLI writes its files.
Besides: the per-frame step dispatches no op that waits for the device,
and the entry points default to CUDA.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_harness import RESOLUTION, Pair, one_torch_thread, to_torch  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.datasets import rollout as JR
from lidarcrafter_tpu.ops.projection import convert_boxes_to_2d as j_boxes2d
from lidarcrafter_tpu.ops.projection import points_to_range_image as j_project
from lidarcrafter_tpu.pipeline import TemporalRollout as JaxRollout
from lidarcrafter_tpu.pipeline.temporal import _image_points_carry
from lidarcrafter_tpu.training.preprocess import preprocess_autoregressive_cond, preprocess_condition_mask
from lidarcrafter_tpu_torch import sample_temporal
from lidarcrafter_tpu_torch.pipeline import TemporalRollout
from lidarcrafter_tpu_torch.pipeline.temporal import frame_conditions, image_points_carry, scene_tracks

S, FRAMES, INTERP = 2, 2, 16
STEPS = {"ddim": 5, "dpmpp_2m": 15}
H, W = RESOLUTION
COND_RTOL, PIXEL_SHARE = 1e-5, 0.999
FRAME0_L2, FRAME_L2 = 1e-4, 1e-3
KEY = jax.random.PRNGKey(5)


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Clear JAX's caches after this module.  It calls the JAX package's
    ``points_to_range_image`` with float depth ranges, which that function
    takes as static arguments; the JAX package's own
    ``refine_points_via_condition_mask`` passes a traced depth range on as
    those static arguments, and in a process whose cache holds the float
    entries, JAX's cache lookup compares the tracer with them and raises
    (``tests/test_rollout_pipeline.py`` fails after this module, passes
    alone)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def stacks():
    return Pair("nuscenes-box-layout-v6", small=True, batch_size=S, seed=0), Pair(
        "nuscenes-auto-reg-v2", small=True, batch_size=S, seed=10
    )


@pytest.fixture(scope="module")
def scenes():
    return sample_temporal.synthetic_scenes(S, seed=3)


def jax_keys(key, frames):
    """Each frame's key in the JAX rollout: ``rng, r = split(rng)`` a frame."""
    out, rng = [], key
    for _ in range(frames + 1):
        rng, r = jax.random.split(rng)
        out.append(r)
    return out


def jax_starts(key, frames):
    """Each frame's x_T as the JAX sampler draws it from the frame's key."""
    return [
        torch.as_tensor(np.array(jax.random.normal(jax.random.split(r)[0], (S, H, W, 2), jnp.float32)))
        for r in jax_keys(key, frames)
    ]


def jax_tracks(trajs, boxes0, classes):
    """``TemporalRollout.rollout``'s per-frame inputs (``temporal.py:271-308``)."""
    egos, objs, Ts = [], [], []
    for s in range(S):
        e, o = JR.expand_future_trajs(trajs[s], M=INTERP)
        egos.append(e)
        objs.append(o)
        Ts.append(JR.compute_inter_frame_transforms(e))
    fut = jax.vmap(JR.warp_boxes_future)(
        jnp.asarray(boxes0), jnp.asarray(np.stack(objs), jnp.float32), jnp.asarray(np.stack(egos), jnp.float32)
    )
    boxes_seq = jnp.concatenate([jnp.asarray(boxes0)[:, None], jnp.moveaxis(fut, 2, 1)[:, : FRAMES - 1]], axis=1)
    return dict(
        boxes=jnp.swapaxes(boxes_seq, 0, 1), next_boxes=jnp.moveaxis(fut[:, :, :FRAMES], 2, 0),
        Ts=jnp.asarray(np.swapaxes(np.stack(Ts)[:, :FRAMES], 0, 1)),
        classes_col=jnp.asarray(classes)[..., None], box_mask=jnp.ones(boxes0.shape[:2], bool),
    )


def jax_conditions(pts, mask, jt, t, lu, P=512):
    """The JAX body's geometry (``temporal.py:106-125``) for frame ``t``."""
    boxes_t, next_boxes, T_t = jt["boxes"][t], jt["next_boxes"][t], jt["Ts"][t]
    box_mask = jt["box_mask"]
    depth_range = dict(min_depth=lu.min_depth, max_depth=lu.max_depth)
    bg_mask, obj_pts, obj_mask = jax.vmap(partial(JR.split_foreground_background, max_points_per_obj=P))(
        pts, mask, boxes_t, box_mask
    )
    bg_next = jax.vmap(JR.transform_points_homogeneous)(pts, T_t)
    next_boxes_cls = jnp.concatenate([next_boxes, jt["classes_col"]], axis=2)
    bg_next, bg_next_mask = jax.vmap(partial(JR.refine_points_via_condition_mask, H=H, W=W, **depth_range))(
        bg_next, bg_mask, next_boxes_cls, box_mask
    )
    fg_pts, fg_mask = jax.vmap(JR.replay_objects)(obj_pts, obj_mask, next_boxes, box_mask)
    all_pts = jnp.concatenate([bg_next, fg_pts.reshape(S, -1, 4)], axis=1)
    all_mask = jnp.concatenate([bg_next_mask, fg_mask.reshape(S, -1)], axis=1)
    img = jax.vmap(partial(j_project, H=H, W=W, **depth_range))(all_pts, all_mask)
    cond = jnp.concatenate([img[..., 4:5] * img[..., 5:6], img[..., 3:4] / 255.0 * img[..., 5:6]], axis=-1)
    _, condition_mask, _ = jax.vmap(partial(j_boxes2d, H=H, W=W))(next_boxes_cls, box_mask)
    concat = preprocess_condition_mask({"condition_mask": condition_mask}, lu, 8)
    return np.asarray(concat), np.asarray(preprocess_autoregressive_cond(cond, lu))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flipped_pixels(got, want):
    """Pixels (of S·H·W) where a condition map differs by more than
    COND_RTOL of max(1, max |want|)."""
    tol = COND_RTOL * max(1.0, float(np.abs(want).max()))
    return int((np.abs(np.asarray(got) - want) > tol).any(-1).sum())


@pytest.fixture(scope="module", params=["ddim", "dpmpp_2m"])
def rollouts(request, stacks, scenes):
    """Both packages' rollouts of the same scenes, weights and x_T."""
    mode = request.param
    cond, auto = stacks
    trajs, boxes0, classes = scenes
    key = KEY
    jpipe = JaxRollout(
        cond_engine=cond.jengine, cond_params=cond.params, autoreg_engine=auto.jengine,
        autoreg_params=auto.params, lidar_utils=auto.jlu, num_sampling_steps=STEPS[mode], sampling_mode=mode,
    )
    jbatch = {k: jnp.asarray(v) for k, v in cond.batch.items()}
    want = [np.asarray(f) for f in jpipe.rollout(
        jbatch, trajs, boxes0, classes, key, num_frames=FRAMES, interp_M=INTERP
    )]
    tpipe = TemporalRollout(
        cond_engine=cond.tengine, autoreg_engine=auto.tengine, lidar_utils=auto.tlu,
        num_sampling_steps=STEPS[mode], sampling_mode=mode, device="cpu",
    )
    starts = jax_starts(key, FRAMES)
    got = tpipe.rollout(to_torch(cond.batch), trajs, boxes0, classes, num_frames=FRAMES,
                        interp_M=INTERP, x_T=starts)
    return dict(mode=mode, want=want, got=got, jpipe=jpipe, tpipe=tpipe, jlu=auto.jlu, tlu=auto.tlu)


def test_scene_tracks_match_jax(scenes):
    trajs, boxes0, classes = scenes
    jt = jax_tracks(trajs, boxes0, classes)
    tt = scene_tracks(trajs, boxes0, classes, FRAMES, INTERP, torch.device("cpu"))
    for got, want in ((tt.boxes, jt["boxes"]), (tt.next_boxes, jt["next_boxes"]), (tt.transforms, jt["Ts"])):
        want = np.swapaxes(np.asarray(want), 0, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert tt.num_frames == FRAMES


def test_teacher_forced_step_matches_jax(rollouts, scenes):
    """(a) The port's step on the JAX package's own previous frames."""
    jt = jax_tracks(*scenes)
    tracks = scene_tracks(*scenes, FRAMES, INTERP, torch.device("cpu"))
    pipe = rollouts["tpipe"]
    for t in range(FRAMES):
        prev = rollouts["want"][t]
        want = jax_conditions(*_image_points_carry(jnp.asarray(prev), rollouts["jlu"]), jt, t, rollouts["jlu"])
        carry = image_points_carry(torch.as_tensor(prev), rollouts["tlu"])
        got = pipe.frame_conditions(*carry, tracks, t)
        for name, g, w in zip(("concat_cond", "autoregressive_cond"), got, want):
            assert g.shape == w.shape
            flips = flipped_pixels(g.numpy(), w)
            print(f"{rollouts['mode']} frame {t + 1} {name}: {flips} of {S * H * W} pixels differ (bin-edge flips)")
            assert flips <= (1 - PIXEL_SHARE) * S * H * W
        assert float(np.abs(want[1]).max()) > 0.5 and (want[0][..., 1:9] > 0).any()  # depth and boxes present


def test_free_running_rollout_matches_jax(rollouts, scenes, stacks):
    """(b) Frames 0-2 of the port's free-running rollout (module docstring)."""
    got, want = rollouts["got"], rollouts["want"]
    assert len(got) == len(want) == FRAMES + 1
    cond, _ = stacks
    jt = jax_tracks(*scenes)
    tracks = scene_tracks(*scenes, FRAMES, INTERP, torch.device("cpu"))
    jlu, tlu = rollouts["jlu"], rollouts["tlu"]
    jbatch = {k: jnp.asarray(v) for k, v in cond.batch.items()}
    keys = jax_keys(KEY, FRAMES)
    for t, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, np.ndarray) and g.shape == w.shape == (S, H, W, 2)
        assert np.isfinite(g).all()
        if t == 0:
            assert _rel(g, w) <= FRAME0_L2
            continue
        carry = image_points_carry(torch.as_tensor(got[t - 1]), tlu)
        port_cond = [c.numpy() for c in rollouts["tpipe"].frame_conditions(*carry, tracks, t - 1)]
        # the geometry on the port's frame: the JAX body's conditions but for bin-edge flips
        concat, autoreg = jax_conditions(*_image_points_carry(jnp.asarray(got[t - 1]), jlu), jt, t - 1, jlu)
        flips = [flipped_pixels(port_cond[0], concat), flipped_pixels(port_cond[1], autoreg)]
        assert max(flips) <= (1 - PIXEL_SHARE) * S * H * W
        # the sampler on the port's conditions
        ref = np.asarray(rollouts["jpipe"].generate_next_frame(
            jnp.asarray(port_cond[1]), dict(jbatch, concat_cond=jnp.asarray(port_cond[0])), keys[t]
        ))
        rel = _rel(g, ref)
        own = jax_conditions(*_image_points_carry(jnp.asarray(want[t - 1]), jlu), jt, t - 1, jlu)
        print(f"{rollouts['mode']} frame {t}: {rel:.3g} relative L2 from the JAX sampler on the port's "
              f"conditions; geometry on the port's frame {t - 1}: {flips} of {S * H * W} pixels flipped; "
              f"from the JAX free-running frame {_rel(g, w):.3g} (conditions differing at "
              f"{[flipped_pixels(a, b) for a, b in zip(port_cond, own)]} pixels)")
        assert rel <= FRAME_L2
    # the conditioning matters: the autoregressive frames differ from frame 0
    assert np.linalg.norm(got[1] - got[0]) > 0.1 * np.linalg.norm(got[0])


def test_stream_chunks_and_fetch_give_the_same_frames(stacks, scenes):
    """(c) ``stream_chunks`` 1 and 2, ``fetch`` on and off."""
    cond, auto = stacks
    pipe = TemporalRollout(cond_engine=cond.tengine, autoreg_engine=auto.tengine, lidar_utils=auto.tlu,
                           num_sampling_steps=2, sampling_mode="ddpm", device="cpu")

    def run(**kw):
        gen = torch.Generator().manual_seed(1)
        return pipe.rollout(to_torch(cond.batch), *scenes, gen, num_frames=FRAMES, interp_M=INTERP, **kw)

    one, two, kept = run(stream_chunks=1), run(stream_chunks=2), run(fetch=False, stream_chunks=2)
    assert len(one) == len(two) == len(kept) == FRAMES + 1
    for a, b, c in zip(one, two, kept):
        assert isinstance(c, torch.Tensor)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())
    assert np.abs(one[2] - one[1]).max() > 1e-2


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bool_index = func is torch.ops.aten.index.Tensor and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None
        )
        self.ops.append("index with a bool mask" if bool_index else func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


# ops whose result the host must read back, and tensors made from host data
# (``lift_fresh``: on the card a copy from pageable memory), so that on the
# card they wait for the work queued before them
HOST_SYNC_OPS = {"nonzero", "item", "_local_scalar_dense", "is_nonzero", "masked_select", "equal",
                 "allclose", "_unique", "_unique2", "unique_dim", "unique_consecutive", "index with a bool mask",
                 "lift_fresh"}


def test_frame_step_dispatches_no_host_sync(stacks, scenes):
    _, auto = stacks
    frame = torch.randn(S, H, W, 2, generator=torch.Generator().manual_seed(0)).clamp(-1, 1)
    tracks = scene_tracks(*scenes, FRAMES, INTERP, torch.device("cpu"))
    rec = _OpRecorder()
    with rec:
        carry = image_points_carry(frame, auto.tlu)
        concat, autoreg = frame_conditions(*carry, tracks.boxes[:, 0], tracks.next_boxes[:, 0],
                                           tracks.transforms[:, 0], tracks.classes_col, tracks.box_mask, auto.tlu)
    assert concat.shape == (S, H, W, 10) and autoreg.shape == (S, H, W, 1)
    assert {"sort", "scatter_", "gather"} <= set(rec.ops)  # the mode saw the step
    assert HOST_SYNC_OPS.isdisjoint(rec.ops), sorted(HOST_SYNC_OPS & set(rec.ops))


def test_cli_writes_a_sequence_per_scene(tmp_path):
    """(d) The CLI at reduced size on the CPU."""
    sample_temporal.main([
        "--synthetic", "2", "--num-frames", "2", "--num-steps", "2", "--resolution", "32", "128",
        "--model-channels", "32", "--device", "cpu", "-o", str(tmp_path),
    ])
    for s in range(2):
        files = sorted((tmp_path / f"seq_{s:04d}").glob("frame_*.txt"))
        assert [f.name for f in files] == ["frame_000.txt", "frame_001.txt", "frame_002.txt"]
        pts = np.loadtxt(files[-1])
        assert pts.ndim == 2 and pts.shape[1] == 3 and len(pts) > 100


def test_rollout_entry_points_raise_without_cuda_unless_cpu_is_asked_for(stacks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cond, auto = stacks
    with pytest.raises(RuntimeError, match="CUDA"):
        TemporalRollout(cond_engine=cond.tengine, autoreg_engine=auto.tengine, lidar_utils=auto.tlu)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_temporal.RolloutGenerator(cond.tcfg, auto.tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_temporal.main(["--synthetic", "1", "--resolution", "32", "128", "--model-channels", "32"])
