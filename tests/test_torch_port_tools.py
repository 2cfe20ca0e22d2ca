"""The eval-scale tools of the PyTorch port against the JAX package's
``tools/``, on the CPU: ``sample_and_save_cond`` (dumps read back through
``load_pth_points``; names, count and tail wrap as the JAX tool's on the
same synthetic nuScenes-format tree), ``generate_box_condition`` (the
condition the port writes equals the JAX tool's ``make_condition`` of the
same clouds and boxes, 1e-6), ``build_clip_cache`` (both subcommands on
random tower weights and a synthetic merges table: the same keys, features
1e-5) and the cluster merge of ``parallel/ddp.py`` in two gloo processes.

The JAX tools run in-process (``tools/*.py`` loaded from their files).
Where a JAX tool would build and sample a model only to name its files,
its factory is replaced by a stub (``generate_box_condition``: both tools' samplers return
the same seeded clouds), so the comparison holds the tool's own work (the
walk, the names, the placement, projection and normalisation) and not a
second sampler: the samplers themselves are held to JAX in
``test_torch_port_object.py`` and ``test_torch_port_sampler.py``.
"""

import gzip
import importlib.util
import json
import os
import pickle
import random
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_clip import MERGES, openai_state_dict
from torch_port_harness import one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

import lidarcrafter_tpu.configs as jcfgs
import lidarcrafter_tpu.training.factory as jfactory
import lidarcrafter_tpu.training.loop as jloop
from lidarcrafter_tpu_torch import build_clip_cache, generate_box_condition, sample_and_save_cond
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
from lidarcrafter_tpu_torch.utils.sample_io import load_pth_image, load_pth_points
from lidarcrafter_tpu_torch.utils.synthetic import point_config_at_tree, write_nuscenes_tree

REPO = Path(__file__).resolve().parent.parent
FEATURE_RTOL = 1e-5
CONDITION_ATOL = 1e-6


def _jax_tool(path: str):
    spec = importlib.util.spec_from_file_location("jax_tool_" + Path(path).stem, REPO / "tools" / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(path: str, argv: list[str], monkeypatch):
    monkeypatch.setattr(sys, "argv", [path, *argv])
    monkeypatch.setenv("LCT_PLATFORM", "cpu")
    _jax_tool(path).main()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_nuscenes_tree(tmp_path_factory.mktemp("nusc"), num_points=3000)


# ------------------------------------------------------- sample_and_save_cond


class _StubDenoiser:
    """Stands in for a flax module: no parameters, zero outputs."""

    def __init__(self, shape):
        self.shape = shape

    def init(self, *args, **kwargs):
        return {}

    def apply(self, params, batch):
        return jnp.zeros(self.shape)


class _StubEngine:
    def __init__(self, B, H, W):
        self.out = jnp.zeros((B, H, W, 2))

    def sample(self, params, rng, batch, batch_size, num_steps, mode):
        return self.out


def test_sample_and_save_cond_walks_the_split_as_jax(tree, tmp_path, monkeypatch):
    """Five frames of the synthetic tree's ``all`` split in batches of two
    (the last batch wraps onto the last item): the port's dumps (reduced
    widths, one DDIM step on the CPU) have the JAX tool's names, count and
    (5, H, W) layout, and read back as points."""
    H, W, B = 32, 64, 2
    real_get = jcfgs.get_config
    monkeypatch.setattr(jcfgs, "get_config", lambda name: point_config_at_tree(real_get(name), tree))
    real_build = jfactory.build_diffusion_training

    def stub_build(cfg):
        _, _, lidar_utils = real_build(cfg)
        L = cfg.condition_model.params["layout_length"]
        return ({"model": _StubDenoiser(()), "cond": _StubDenoiser((B, L, 4))}, _StubEngine(B, H, W), lidar_utils)

    monkeypatch.setattr(jfactory, "build_diffusion_training", stub_build)
    import lidarcrafter_tpu.training as jtraining

    monkeypatch.setattr(jtraining, "build_diffusion_training", stub_build)
    random.seed(0)  # the JAX dataset shuffles ``all`` with the global generator; the port's ``--seed 0``
    common = ["-c", "nuscenes-auto-reg-v2", "--num-sample", "5", "-b", str(B), "--num-steps", "1", "--mode", "ddim",
              "--resolution", str(H), str(W)]
    _run_jax_tool("sample_and_save_cond.py", [*common, "-o", str(tmp_path / "jax")], monkeypatch)
    sets = [f"data.{k}={json.dumps(tree[k])}" for k in ("data_root", "pkl_path", "clip_cache_dir")]
    sample_and_save_cond.main([*common, "--model-channels", "32", "--device", "cpu", "-o", str(tmp_path / "port"),
                               *[a for s in sets for a in ("--set", s)]])
    want = sorted(p.name for p in (tmp_path / "jax").glob("samples_*.pth"))
    got = sorted((tmp_path / "port").glob("samples_*.pth"))
    assert [p.name for p in got] == want and len(want) == 5
    assert want[0].startswith("samples_0000000_") and want[-1].startswith("samples_0000004_")
    for p in got:
        img = load_pth_image(p)
        assert img.shape == (5, H, W) and np.isfinite(img).all()
        pts = load_pth_points(p)
        assert pts.ndim == 2 and pts.shape[1] == 4


def test_sample_and_save_cond_synthetic(tmp_path):
    """``--synthetic 3`` in batches of two, as the JAX CLI test runs it:
    three dumps named ``samples_000000k_synthetick``; ``--format txt``
    writes point files."""
    args = ["-c", "nuscenes-auto-reg-v2", "--synthetic", "3", "-b", "2", "--num-steps", "1", "--mode", "ddim",
            "--resolution", "32", "64", "--model-channels", "32", "--device", "cpu"]
    sample_and_save_cond.main([*args, "-o", str(tmp_path / "pth")])
    files = sorted((tmp_path / "pth").glob("samples_*.pth"))
    assert [f.name for f in files] == [f"samples_{i:07d}_synthetic{i}.pth" for i in range(3)]
    assert load_pth_image(files[0]).shape == (5, 32, 64)
    sample_and_save_cond.main([*args, "--format", "txt", "-o", str(tmp_path / "txt")])
    txt = sorted((tmp_path / "txt").glob("samples_*.txt"))
    assert len(txt) == 3 and np.loadtxt(txt[0]).shape[1] == 3


# ----------------------------------------------------- generate_box_condition


def _box_frame_clouds(boxes: dict, seed: int) -> np.ndarray:
    """Seeded (B, 1024, 4) clouds in the box frame, [-1, 1] on each axis:
    what a trained object model gives (seeded random weights give clouds
    hundreds of box sizes wide, all beyond the range image's depth)."""
    B = len(np.asarray(boxes["fg_class"]))
    return np.random.RandomState(seed).uniform(-1, 1, (B, 1024, 4)).astype(np.float32)


def test_generate_box_condition_equals_jax_make_condition(tmp_path, monkeypatch):
    """Both tools place and project the same clouds at the same synthetic
    boxes: the same conditions (1e-6), with objects in the class channel."""
    monkeypatch.setattr(ObjectGenerator, "generate",
                        lambda self, boxes, num_steps, mode="ddpm", seed=0: torch.as_tensor(_box_frame_clouds(boxes, seed)))
    args = ["--random-params", "--synthetic-scenes", "2", "--num-steps", "2"]
    generate_box_condition.main([*args, "--device", "cpu", "-o", str(tmp_path / "port")])
    calls = []

    class Engine:
        def sample(self, params, rng, batch_dict, batch_size, num_steps, mode):
            assert mode == "ddpm" and num_steps == 2
            calls.append(batch_size)
            return jnp.asarray(_box_frame_clouds(batch_dict, len(calls) - 1))

    class Trainer:
        def __init__(self, *a, **k):
            pass

        def init_state(self, rng):
            return type("State", (), {"params": None})()

    monkeypatch.setattr(jfactory, "build_object_training", lambda cfg: ({}, Engine(), None))
    monkeypatch.setattr(jloop, "ObjectTrainer", Trainer)
    _run_jax_tool("generate_box_condition.py", [*args, "-o", str(tmp_path / "jax")], monkeypatch)
    assert calls == [3, 3]
    names = sorted(p.name for p in (tmp_path / "jax" / "train").glob("*.npy"))
    assert names == ["sample_0000000.npy", "sample_0000001.npy"]
    for name in names:
        got, want = (np.load(tmp_path / side / "train" / name) for side in ("port", "jax"))
        assert got.shape == want.shape == (3, 32, 1024) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=CONDITION_ATOL)
        assert (want[-1] > 0).sum() > 100  # the class channel holds the objects


def test_generate_box_condition_samples_the_object_model(tmp_path):
    """The CLI as it runs: seeded weights, 2 DDPM steps per scene on the
    CPU, one finite (3, 32, 1024) condition per scene."""
    generate_box_condition.main(["--random-params", "--synthetic-scenes", "2", "--num-steps", "2",
                                 "--device", "cpu", "-o", str(tmp_path)])
    files = sorted((tmp_path / "train").glob("*.npy"))
    assert [f.name for f in files] == ["sample_0000000.npy", "sample_0000001.npy"]
    for f in files:
        cond = np.load(f)
        assert cond.shape == (3, 32, 1024) and np.isfinite(cond).all()


# ------------------------------------------------------------ build_clip_cache


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clipw")
    sd = openai_state_dict(2)
    torch.save({k: v for k, v in sd.items() if k != "logit_scale"}, d / "clip.pt")
    with gzip.open(d / "bpe.txt.gz", "wt") as f:
        f.write("\n".join(MERGES))
    return str(d / "clip.pt"), str(d / "bpe.txt.gz")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_RTOL * max(1.0, float(np.abs(want).max())))


def test_build_clip_cache_obj_text(clip_files, tmp_path, monkeypatch):
    clip, bpe = clip_files
    build_clip_cache.main(["obj-text", "--clip", clip, "--bpe", bpe, "--save_path", str(tmp_path / "port.pkl"),
                           "--device", "cpu"])
    _run_jax_tool("converters/build_clip_cache.py",
                  ["obj-text", "--clip", clip, "--bpe", bpe, "--save_path", str(tmp_path / "jax.pkl")], monkeypatch)
    got, want = (pickle.loads((tmp_path / f"{s}.pkl").read_bytes()) for s in ("port", "jax"))
    assert list(got) == list(want) == list(build_clip_cache.CLASS_NAMES)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (1, 48)
        _close(got[k], want[k])


def test_build_clip_cache_warm_cache(clip_files, tree, tmp_path, monkeypatch):
    """Both tools warm an empty cache over the tree's val split: the same
    ``CLIP_%07d.pkl`` files, the same words, features 1e-5."""
    clip, bpe = clip_files
    args = ["warm-cache", "--clip", clip, "--bpe", bpe, "--pkl", tree["pkl_path"], "--data_root", tree["data_root"],
            "--split", "val"]

    def cache_at(get, where):
        def wrapped(name):
            cfg = get(name)
            cfg.data.clip_cache_dir = str(tmp_path / where)
            return cfg
        return wrapped

    monkeypatch.setattr(build_clip_cache, "get_config", cache_at(tcfgs.get_config, "port"))
    build_clip_cache.main([*args, "--device", "cpu"])
    monkeypatch.setattr(jcfgs, "get_config", cache_at(jcfgs.get_config, "jax"))
    _run_jax_tool("converters/build_clip_cache.py", args, monkeypatch)
    want = sorted(p.name for p in (tmp_path / "jax" / "val").glob("CLIP_*.pkl"))
    assert want and sorted(p.name for p in (tmp_path / "port" / "val").glob("CLIP_*.pkl")) == want
    for name in want:
        got, ref = (pickle.loads((tmp_path / s / "val" / name).read_bytes()) for s in ("port", "jax"))
        assert list(got) == list(ref) and list(got["rel_feats"]) == list(ref["rel_feats"])
        _close(got["instance_feats"], ref["instance_feats"])
        for w in ref["rel_feats"]:
            _close(got["rel_feats"][w], ref["rel_feats"][w])


# --------------------------------------------------------------- cluster merge

_WORKER = r"""
import json, sys

import numpy as np

from lidarcrafter_tpu_torch.parallel.ddp import initialize_distributed, is_main_process, merge_results_dist

init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
group = initialize_distributed(rank, 2, init, device="cpu")
records = [np.full((2,), 10 * rank + i, np.float32) for i in range(3)]
merged = merge_results_dist(records)
assert all(isinstance(m, np.ndarray) and m.shape == (2,) and m[0] == m[1] for m in merged)
with open(out, "w") as f:
    json.dump({"merged": [float(m[0]) for m in merged], "is_main": is_main_process()}, f)
group.leave()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cluster_merge(tmp_path):
    """Two gloo ranks each contribute three records: every rank holds all
    six, rank 0's first, the list ``tests/test_multihost.py::
    test_two_process_cluster_merge`` reads from the JAX merge (sorted there;
    in rank order here), and only rank 0 is the main process."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), init, str(r), str(tmp_path / f"out_{r}.json")], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    results = [json.loads((tmp_path / f"out_{r}.json").read_text()) for r in range(2)]
    for r in results:
        assert r["merged"] == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
    assert results[0]["is_main"] and not results[1]["is_main"]


def test_merge_is_the_identity_in_one_process():
    from lidarcrafter_tpu_torch.parallel.ddp import is_main_process, merge_results_dist

    records = [np.arange(3), {"a": 1}]
    assert merge_results_dist(records) == records and is_main_process()
