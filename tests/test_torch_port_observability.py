"""The port's training observability against the JAX package's, on the CPU.

(a) ``utils/render.py``: ``colorize``, ``render_point_clouds`` and
    ``estimate_surface_normal`` (both modes) on the same inputs, and
    ``training/tracker.py::render_sample_images`` on the same sample batch:
    images in [0, 1] to 1/255, the uint8 renders to 1 level.
(b) ``utils/progress.py`` (``Bar``, ``progress_bar``, ``format_eta``) and
    ``utils/profiling.py::StepTimer`` against the JAX modules on a shared
    fake clock: the same text, the same means.
(c) ``JsonlTracker``: ``events.jsonl`` records as the JAX tracker's, PNGs
    written with ``zlib`` + ``struct`` that decode (here with the port's
    reader and with PIL) to the pixels the JAX tracker writes through PIL;
    ``TensorBoardTracker`` writes an event file (skipped without the
    ``tensorboard`` package).
(d) A short ``Trainer.train`` with ``JsonlTracker`` (the reduced
    ``nuscenes-unet-uncond``): ``loss`` / ``lr`` / ``sec_per_step`` on
    steps 1, 2, …; the ``sample_depth``, ``sample_bev`` and
    ``sample_reflectance`` PNGs of the EMA preview (as the JAX
    ``test_trainer_cli.py::test_trainer_observability``); the profiling
    window's Chrome trace; a failing preview logged as ``preview_error``
    while training goes on; a step under ``torch.no_grad``; the MeanFlow
    preview.
(e) The ``train`` CLI from nuScenes-format files on the CPU (the reduced
    ``nuscenes-auto-reg-v2``, 2 loader threads, a preview and a profile),
    and its message without data.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.training import tracker as jtracker
from lidarcrafter_tpu.utils import profiling as jprofiling
from lidarcrafter_tpu.utils import progress as jprogress
from lidarcrafter_tpu.utils import render as jrender
from lidarcrafter_tpu.utils.lidar import LiDARUtility as JLiDARUtility
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.training import tracker as ttracker
from lidarcrafter_tpu_torch.training.loop import FlowTrainer, Trainer
from lidarcrafter_tpu_torch.utils import profiling as tprofiling
from lidarcrafter_tpu_torch.utils import progress as tprogress
from lidarcrafter_tpu_torch.utils import render as trender
from lidarcrafter_tpu_torch.utils.lidar import LiDARUtility
from lidarcrafter_tpu_torch.utils.synthetic import write_nuscenes_tree

LEVEL = 1 / 255


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_colorize_matches_jax():
    x = np.random.RandomState(0).rand(2, 8, 16, 1).astype(np.float32)
    np.testing.assert_allclose(trender.colorize(_t(x)).numpy(), np.asarray(jrender.colorize(jnp.asarray(x))),
                               atol=LEVEL)
    np.testing.assert_allclose(trender.colorize(_t(x[..., 0] * 1.5 - 0.2)).numpy(),
                               np.asarray(jrender.colorize(jnp.asarray(x[..., 0] * 1.5 - 0.2))), atol=LEVEL)


@pytest.mark.parametrize("mode", ["closest", "mean"])
def test_surface_normals_match_jax(mode):
    p = np.random.RandomState(1).randn(2, 8, 32, 3).astype(np.float32)
    got = trender.estimate_surface_normal(_t(p), mode=mode).numpy()
    np.testing.assert_allclose(got, np.asarray(jrender.estimate_surface_normal(jnp.asarray(p), mode=mode)),
                               atol=LEVEL)


def test_render_point_clouds_matches_jax():
    rnd = np.random.RandomState(2)
    pts, colors = rnd.randn(2, 800, 3).astype(np.float32) * 0.3, rnd.rand(2, 800, 3).astype(np.float32)
    R, t = trender.make_Rt(pitch=0.3, z=1.0)
    jR, jt = jrender.make_Rt(pitch=0.3, z=1.0)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-7)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt))
    for kw, jkw in (({"t": torch.tensor([0.0, 0.0, 1.0])}, {"t": jnp.asarray([0.0, 0.0, 1.0])}),
                    ({"R": R, "t": t}, {"R": jR, "t": jt})):
        got = trender.render_point_clouds(_t(pts), _t(colors), size=96, **kw).numpy()
        want = np.asarray(jrender.render_point_clouds(jnp.asarray(pts), jnp.asarray(colors), size=96, **jkw))
        assert got.shape == (2, 96, 96, 3) and got.max() > 0.5
        np.testing.assert_allclose(got, want, atol=LEVEL)


def test_render_sample_images_matches_jax():
    H, W = 16, 64
    sample = np.random.RandomState(3).uniform(-1, 1, (2, H, W, 2)).astype(np.float32)
    sample[..., 0] = np.clip(sample[..., 0] * 0.3 + 0.4, -1, 1)  # depths inside the range
    kw = dict(fov_up=10.0, fov_down=-30.0)
    got = ttracker.render_sample_images(_t(sample), LiDARUtility.create((H, W), "log_depth", 1.45, 80.0, **kw),
                                        bev_size=128)
    want = jtracker.render_sample_images(jnp.asarray(sample), JLiDARUtility.create((H, W), "log_depth", 1.45, 80.0,
                                                                                   **kw), bev_size=128)
    assert set(got) == set(want) == {f"sample/{k}" for k in ("depth", "depth_orig", "mask", "bev", "reflectance")}
    for k in want:
        assert got[k].dtype == np.uint8 and got[k].shape == want[k].shape, k
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
    assert got["sample/bev"].max() > 0


# ------------------------------------------------------------------ (b)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.37
        return self.now


def test_progress_matches_jax(monkeypatch):
    for value in (0, 44.6, 59.5, 61, 3599, 3600 * 5 + 7, 86400 * 2 + 3600 * 3):
        assert tprogress.format_eta(value) == jprogress.format_eta(value)
    outs = []
    for mod in (tprogress, jprogress):
        monkeypatch.setattr(mod.time, "monotonic", _Clock())
        stream = io.StringIO()
        for _ in mod.Bar.wrap(range(23), desc="feats", stream=stream):
            pass
        bar = mod.Bar(0, desc="open", stream=stream)
        for _ in range(5):
            bar.update()
        bar.close()
        for i in range(7):
            mod.progress_bar(i, 7, msg=f"item {i}", desc="fn", stream=stream)
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] and "feats [" in outs[0] and "eta" in outs[0]


def test_step_timer_matches_jax(monkeypatch):
    means = []
    for mod in (tprofiling, jprofiling):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock())
        timer = mod.StepTimer(window=3)
        means.append([(timer.tick(), timer.mean) for _ in range(5)])
    assert means[0] == means[1]


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with tprofiling.trace(str(tmp_path)):
        torch.ones(4) * 2
    assert json.loads((tmp_path / "trace.pt.trace.json").read_text())["traceEvents"]
    with tprofiling.trace(None) as prof:
        assert prof is None


# ------------------------------------------------------------------ (c)


def test_jsonl_tracker_matches_jax(tmp_path):
    from PIL import Image

    rnd = np.random.RandomState(4)
    images = {"sample/depth": rnd.randint(0, 256, (2, 8, 16, 3)).astype(np.uint8),
              "sample/bev": rnd.rand(12, 12, 3).astype(np.float32)}
    records = []
    for mod, d in ((ttracker, tmp_path / "port"), (jtracker, tmp_path / "jax")):
        tr = mod.JsonlTracker(str(d))
        tr.log({"loss": np.float32(0.25), "lr": 1e-4}, 3)
        tr.log_images(images, 3)
        tr.close()
        records.append([json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()])
    for got, want in zip(*records):
        assert set(got) == set(want) and {k: got[k] for k in ("step", "loss", "lr")} == \
            {k: want[k] for k in ("step", "loss", "lr")}
    for tag in ("sample_depth", "sample_bev"):
        png = tmp_path / "port" / "images" / "0000000003" / f"{tag}.png"
        want = np.asarray(Image.open(tmp_path / "jax" / "images" / "0000000003" / f"{tag}.png"))
        np.testing.assert_array_equal(ttracker.read_png(png), want)
        np.testing.assert_array_equal(np.asarray(Image.open(png)), want)
    assert ttracker.read_png(tmp_path / "port" / "images" / "0000000003" / "sample_depth.png").shape == (16, 16, 3)
    grey = rnd.randint(0, 256, (5, 7)).astype(np.uint8)
    ttracker.write_png(tmp_path / "grey.png", grey)
    np.testing.assert_array_equal(ttracker.read_png(tmp_path / "grey.png"), grey)
    assert ttracker.make_tracker(None, str(tmp_path)) is None
    with pytest.raises(ValueError):
        ttracker.make_tracker("wandb", str(tmp_path))


def test_tensorboard_tracker_writes_events(tmp_path):
    pytest.importorskip("tensorboard")
    tr = ttracker.make_tracker("tensorboard", str(tmp_path))
    tr.log({"loss": 0.5}, 1)
    tr.log_images({"sample/depth": np.zeros((4, 4, 3), np.uint8)}, 1)
    tr.close()
    assert list(tmp_path.glob("events.out.tfevents.*"))


# ------------------------------------------------------------------ (d)


def _uncond_cfg(name="nuscenes-unet-uncond"):
    cfg = tcfgs.apply_reduced_topology(tcfgs.get_config(name), resolution=(16, 64))
    cfg.model.params.update(base_channels=16, num_residual_blocks=(1, 1, 1, 1))
    t = cfg.training
    t.batch_size_train, t.lr_warmup_steps, t.num_steps, t.mixed_precision = 1, 1, 10, "no"
    return cfg


def test_trainer_logs_previews_and_profiles(tmp_path):
    cfg = _uncond_cfg()
    tracker = ttracker.JsonlTracker(str(tmp_path / "log"))
    logs = []
    trainer = Trainer(cfg, train_cli.synthetic_batches(cfg, 0), output_dir=tmp_path, log_fn=logs.append,
                      device="cpu", tracker=tracker, profile_dir=str(tmp_path / "prof"), preview_num_steps=2,
                      preview_batch_size=1)
    trainer.train(num_steps=6, checkpoint_every=0, preview_every=3, log_every=1)
    events = [json.loads(line) for line in (tmp_path / "log" / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2, 3, 4, 5, 6]
    for e in events:
        assert {"loss", "lr", "sec_per_step", "wall_time"} <= set(e) and np.isfinite(e["loss"])
    tags = {p.stem for p in (tmp_path / "log" / "images").rglob("*.png")}
    assert {"sample_depth", "sample_bev", "sample_reflectance"} <= tags
    assert sorted(p.name for p in (tmp_path / "log" / "images").iterdir()) == ["0000000003", "0000000006"]
    for png in (tmp_path / "log" / "images").rglob("*.png"):
        assert ttracker.read_png(png).ndim == 3
    trace = json.loads((tmp_path / "prof" / "train_steps.pt.trace.json").read_text())
    assert trace["traceEvents"]
    assert not any("preview_error" in r for r in logs)

    # a preview that fails is logged and training goes on
    def broken(*a, **k):
        raise RuntimeError("no preview")

    trainer.preview_images = broken
    trainer.train(num_steps=2, checkpoint_every=0, preview_every=1, log_every=1)
    tracker.close()
    assert [r["preview_error"] for r in logs if "preview_error" in r] == ["no preview", "no preview"]


def test_a_train_step_takes_gradients_under_no_grad():
    """The step computes its gradients whatever the caller's grad mode (an
    in-process CLI or a serving call may have turned it off)."""
    cfg = _uncond_cfg()
    trainer = Trainer(cfg, train_cli.synthetic_batches(cfg, 0), log_fn=None, device="cpu")
    with torch.no_grad():
        state = trainer.train(num_steps=1, checkpoint_every=0)
    assert state.step == 1 and any(float(m.abs().sum()) > 0 for m in state.opt_state["mu"])


def test_flow_trainer_preview():
    cfg = _uncond_cfg("meanflow-nusc")
    trainer = FlowTrainer(cfg, train_cli.synthetic_batches(cfg, 0), log_fn=None, device="cpu", preview_batch_size=1)
    images = trainer.preview_images(trainer.init_state(0), 0)
    assert {"sample/depth", "sample/bev", "sample/reflectance"} <= set(images)
    assert images["sample/depth"].shape == (1, 16, 64, 3)


# ------------------------------------------------------------------ (e)


def test_train_cli_from_files(tmp_path, capsys):
    tree = write_nuscenes_tree(tmp_path / "nusc", num_scenes=1, frames=3, num_points=3000)
    out = tmp_path / "run"
    args = ["-c", "nuscenes-auto-reg-v2", "--device", "cpu", "--resolution", "32", "128", "--model-channels", "32",
            "-b", "1", "--set", f'data.data_root="{tree["data_root"]}"',
            "--set", f'data.pkl_path="{tree["pkl_path"]}"', "--set", "training.mixed_precision=\"no\"",
            "--workers", "2", "--num-steps", "4", "--log-every", "1", "--checkpoint-every", "4",
            "--log-dir", str(out / "log"), "--set", "training.steps_save_image=2",
            "--set", "diffusion.num_sampling_steps=1",
            "--profile-dir", str(out / "prof"), "--output-dir", str(out)]
    train_cli.main(args)
    logs = capsys.readouterr().out
    assert "'step': 4" in logs and "preview_error" not in logs
    assert (out / "ckpt_0000000004" / "state.pt").exists()
    assert (out / "prof" / "train_steps.pt.trace.json").exists()
    events = [json.loads(line) for line in (out / "log" / "events.jsonl").read_text().splitlines()]
    assert [e["step"] for e in events] == [1, 2, 3, 4]
    assert {p.stem for p in (out / "log" / "images" / "0000000004").glob("*.png")} >= {
        "sample_depth", "sample_bev", "sample_reflectance"}
    with pytest.raises(SystemExit, match="no training data"):
        train_cli.main(["-c", "nuscenes-auto-reg-v2", "--device", "cpu", "--set", 'data.pkl_path="/nonexistent.pkl"'])
    with pytest.raises(SystemExit, match="kitti_360"):
        train_cli.main(["-c", "kitti-360", "--device", "cpu"])
