"""The metric suite end to end in the PyTorch port against the JAX package,
on the CPU: ``evaluate`` (cd, emd, jsd, mmd, frid from features and from a
pretrained RangeNet folder), ``EvaluationEngine.evaluate`` with RangeNet-21
and PointNet through the weight bridge and its feature cache, and the two
entry points (``evaluate``, ``evaluate_temporal``) with ``--device cpu``
on a ``tmp_path`` of sample files against the JAX package's tools run on
the same files; FSVD / FPVD through MinkowskiNet / SPVCNN checkpoints of a
pretrained root.

Limits: chamfer, EMD, JSD and MMD 1e-5 relative (the engine's RBF-kernel
``mmd`` of histograms, a difference of kernel means near 1, 1e-6
absolute); Fréchet distances and
squared MMDs of features 1e-4 relative (the JAX side in float64 through
``jax.enable_x64``, as the port computes them: with fewer clouds than
feature dims the covariances are rank-deficient, and float32 round-off
there moves the result by ~1e-3); features 1e-4 of the largest; TCD and
TTCE 1e-5.
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

import lidarcrafter_tpu.ops.projection as JPROJ
from lidarcrafter_tpu.metrics import evaluate as jax_evaluate
from lidarcrafter_tpu.metrics import eval_suite as JES
from lidarcrafter_tpu.metrics.engine import EvaluationEngine as JaxEngine
from lidarcrafter_tpu.metrics.extractor import pointnet as JPN
from lidarcrafter_tpu.metrics.extractor import rangenet as JRN
from lidarcrafter_tpu.utils.lidar import LiDARUtility as JaxLiDARUtility
from lidarcrafter_tpu_torch import evaluate as evaluate_cli
from lidarcrafter_tpu_torch import evaluate_temporal as temporal_cli
from lidarcrafter_tpu_torch.metrics import eval_suite as TES
from lidarcrafter_tpu_torch.metrics import evaluate
from lidarcrafter_tpu_torch.metrics.engine import EvaluationEngine
from lidarcrafter_tpu_torch.metrics.extractor import pointnet as TPN
from lidarcrafter_tpu_torch.metrics.extractor import rangenet as TRN
from lidarcrafter_tpu_torch.metrics.extractor import sparse_unet as TSU
from lidarcrafter_tpu_torch.metrics.pretrained import pointnet_features, rangenet_lidargen
from lidarcrafter_tpu_torch.utils.lidar import LiDARUtility
from lidarcrafter_tpu_torch.utils.sample_io import save_pth_sample
from lidarcrafter_tpu_torch.weights import init_random_, load_flax_params

REPO = Path(__file__).resolve().parent.parent
RTOL, FEATURE_RTOL = 1e-5, 1e-4


def scan(rnd, n=400):
    """A LiDAR-like cloud: ranges 3-50 m over the sensor's elevations, with
    a remission column."""
    r = rnd.uniform(3, 50, n)
    az = rnd.uniform(-np.pi, np.pi, n)
    el = rnd.uniform(-0.5, 0.15, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el), rnd.rand(n)],
                    1).astype(np.float32)


@pytest.fixture(scope="module")
def clouds():
    rnd = np.random.RandomState(0)
    real = [scan(rnd) for _ in range(3)]
    gen = [(c + 0.3 * rnd.randn(*c.shape)).astype(np.float32) for c in real]
    return real, gen


def test_evaluate_matches_jax(clouds, capsys):
    real, gen = clouds
    feats = tuple(np.random.RandomState(1).randn(2, 40, 8).astype(np.float32))
    metrics = ["cd", "emd", "jsd", "mmd", "frid"]
    got = evaluate(real, gen, metrics, features={"range": feats}, device="cpu")
    printed = capsys.readouterr().out
    want = jax_evaluate(real, gen, metrics, features={"range": feats})
    assert list(got) == metrics
    for name in metrics:
        assert f"|                {name.upper().ljust(4)}:" in printed
        np.testing.assert_allclose(got[name], want[name], rtol=FEATURE_RTOL if name == "frid" else RTOL, err_msg=name)
    assert all(got[m] > 0 for m in metrics)


def test_evaluate_refuses_what_it_cannot_compute(clouds, tmp_path):
    real, gen = clouds
    for name, folder in (("fsvd", "minkowskinet"), ("fpvd", "spvcnn")):
        with pytest.raises(FileNotFoundError, match=f"nuscenes/{folder}/model.ckpt"):
            evaluate(real, gen, [name], pretrained_root=str(tmp_path), device="cpu")
        with pytest.raises(ValueError, match="precomputed"):
            evaluate(real, gen, [name], device="cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        evaluate(real, gen, ["fid"], device="cpu")
    with pytest.raises(ValueError):
        evaluate(real, [g[:-1] for g in gen], ["emd"], device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):  # the card unless the caller asks for the CPU
        evaluate(real, gen, ["cd"])


@pytest.fixture(scope="module")
def rangenet_folder(tmp_path_factory):
    """A pretrained folder ``{root}/nuscenes/rangenet`` with a RangeNet-21
    of seeded weights under upstream's darknet names."""
    model = TRN.RangeNet(num_classes=17, backbone=21)
    jmodel = JRN.RangeNet(num_classes=17, backbone=21)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 64, 5))), 7)
    load_flax_params(model, params)
    root = tmp_path_factory.mktemp("pretrained")
    folder = root / "nuscenes" / "rangenet"
    folder.mkdir(parents=True)
    backbone, decoder = TRN.to_rangenet_folder(model.state_dict())
    torch.save(backbone, folder / "backbone")
    torch.save(decoder, folder / "segmentation_decoder")
    return root


@pytest.fixture
def small_range_images(monkeypatch):
    """Both packages' FRID projection at 16x64 instead of the dataset's
    32x1024 (whose RangeNet forward takes seconds a cloud on a CPU); the
    descriptor's 16 bands need H a multiple of 16."""
    def at_16x64(project):
        return lambda *a, **kw: project(*a, **{**kw, "H": 16, "W": 64})

    monkeypatch.setattr(JPROJ, "points_to_range_image", at_16x64(JPROJ.points_to_range_image))
    monkeypatch.setattr(TES, "points_to_range_image", at_16x64(TES.points_to_range_image))


def test_frid_from_a_pretrained_folder_matches_jax(clouds, rangenet_folder, small_range_images):
    real, gen = clouds
    root = str(rangenet_folder)
    got = TES._range_descriptors(real, "32", root, device="cpu")
    both = JES._range_descriptors(real + gen, "32", root)  # one load and one compile
    want = both[:3], both[3:]
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=0, atol=FEATURE_RTOL * np.abs(want[0]).max())
    frid = evaluate(real, gen, ["frid"], pretrained_root=root, verbose=False, device="cpu")["frid"]
    with jax.enable_x64():  # what the JAX evaluate computes from these descriptors, in float64
        np.testing.assert_allclose(frid, JES.compute_fd(*want), rtol=FEATURE_RTOL)


SPARSE_WIDTHS = (8, 8, 12, 8, 16, 8, 8, 12, 8)


def test_fsvd_fpvd_from_a_pretrained_root_match_jax(clouds, tmp_path, capsys):
    """``evaluate -m fsvd fpvd --pretrained-root`` (the CLI, on the CPU)
    against what the JAX ``evaluate`` computes from the same torchsparse
    checkpoints: its descriptors of both sets, then the Fréchet distance
    in float64."""
    real, gen = clouds
    for folder, cls in (("minkowskinet", TSU.MinkowskiNet), ("spvcnn", TSU.SPVCNN)):
        model = init_random_(cls(layer_num=SPARSE_WIDTHS, cr=1.0), 11)
        (tmp_path / "nuscenes" / folder).mkdir(parents=True)
        torch.save(TSU.to_torchsparse_state_dict(model.state_dict()), tmp_path / "nuscenes" / folder / "model.ckpt")
    dirs = {}
    for tag, cs in (("real", real), ("gen", gen)):
        dirs[tag] = tmp_path / tag
        dirs[tag].mkdir()
        for i, c in enumerate(cs):
            np.save(dirs[tag] / f"{i:03d}.npy", c[:, :3])
    P = 256
    got = evaluate_cli.main(["--real", str(dirs["real"]), "--gen", str(dirs["gen"]), "-m", "fsvd", "fpvd",
                             "--pretrained-root", str(tmp_path), "--sparse-max-points", str(P), "--device", "cpu",
                             "-o", str(tmp_path / "out.json")])
    assert json.loads((tmp_path / "out.json").read_text()) == got and list(got) == ["fsvd", "fpvd"]
    clouds3 = [c[:, :3] for c in real + gen]
    for name, folder in (("fsvd", "minkowskinet"), ("fpvd", "spvcnn")):
        want = JES._sparse_descriptors(clouds3, folder, "32", str(tmp_path), P)  # one load and one compile
        mine = torch.cat([TES._sparse_descriptors(c, folder, "32", str(tmp_path), P, device="cpu")
                          for c in (real, gen)]).numpy()
        assert mine.shape == (6, 16 * SPARSE_WIDTHS[-1])
        np.testing.assert_allclose(mine, want, rtol=0, atol=FEATURE_RTOL * np.abs(want).max())
        with jax.enable_x64():  # what the JAX evaluate computes from these descriptors, in float64
            np.testing.assert_allclose(got[name], JES.compute_fd(want[:3], want[3:]), rtol=FEATURE_RTOL)
        assert got[name] > 0


@pytest.fixture(scope="module")
def engines(clouds, tmp_path_factory):
    """The port's and the JAX package's engines at 16x64 with the same
    RangeNet-21 and PointNet weights, each with a cache directory.  Both
    extractors keep their first 256 features: a Fréchet distance over all
    4,096 takes ~10 s of float64 eigendecompositions on one CPU thread (the
    card computes them at full width)."""
    jr = JRN.RangeNet(num_classes=17, backbone=21)
    jp = JPN.PointNetFeatureExtractor()
    rparams = random_params(jax.eval_shape(jr.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 64, 5))), 8)
    pparams = random_params(jax.eval_shape(jp.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 3))), 9)
    japply_r = jax.jit(lambda img: jr.apply(rparams, JRN.preprocess_range_input(img), "lidargen")[:, :256])
    japply_p = jax.jit(lambda pts: jp.apply(pparams, pts)[:, :256])
    tapply_r = rangenet_lidargen(load_flax_params(TRN.RangeNet(num_classes=17, backbone=21), rparams))
    tapply_p = pointnet_features(load_flax_params(TPN.PointNetFeatureExtractor(), pparams))
    kw = {"num_points_pointnet": 64}
    jaxe = JaxEngine(JaxLiDARUtility.create((16, 64), "log_depth", 1.45, 80.0), japply_r, japply_p,
                     cache_dir=str(tmp_path_factory.mktemp("jax_cache")), **kw)
    port = EvaluationEngine(LiDARUtility.create((16, 64), "log_depth", 1.45, 80.0),
                            lambda img: tapply_r(img)[:, :256], lambda pts: tapply_p(pts)[:, :256],
                            cache_dir=str(tmp_path_factory.mktemp("port_cache")), device="cpu", **kw)
    return jaxe, port


METRICS = ("frd", "fpd", "jsd", "mmd", "cd")  # emd: the same compute_emd as test_evaluate_matches_jax


def test_engine_range_input_matches_jax(clouds, engines):
    jaxe, port = engines
    for c in (clouds[0][0], clouds[0][0][:, :3]):
        got = port._range_input(torch.as_tensor(c)).numpy().transpose(0, 2, 3, 1)
        want = np.asarray(jaxe._range_input(c))
        np.testing.assert_array_equal(got != 0, want != 0)  # the same pixels hit, from the same points
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_engine_evaluate_matches_jax_and_reads_its_cache(clouds, engines, tmp_path):
    real, gen = clouds
    jaxe, port = engines
    got = port.evaluate(real, gen, METRICS, output_json=str(tmp_path / "port.json"))
    want = jaxe.evaluate(real, gen, METRICS)
    with jax.enable_x64():  # the Fréchet distances again, from the JAX engine's cache, in float64
        want.update(jaxe.evaluate(real, gen, ("frd", "fpd")))
    assert list(got) == list(want) == ["frd", "frd_mmd", "fpd", "fpd_mmd", "jsd", "mmd", "cd"]
    for k in want:
        if k == "mmd":  # a difference of RBF kernel means near 1: float32 round-off is ~1e-7 absolute
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL if k in ("jsd", "cd", "emd") else FEATURE_RTOL,
                                       err_msg=k)
    assert json.loads((tmp_path / "port.json").read_text()) == {k: float(v) for k, v in got.items()}
    for tag in ("real", "gen"):
        with open(port.cache_dir / f"features_{tag}.pkl", "rb") as f:
            ours = pickle.load(f)
        with open(jaxe.cache_dir / f"features_{tag}.pkl", "rb") as f:
            theirs = pickle.load(f)
        assert sorted(ours) == sorted(theirs) and ours["voxel"] is None and theirs["voxel"] is None
        for k in ("rangenet", "pointnet", "bev_hist"):
            assert ours[k].shape == theirs[k].shape and ours[k].dtype == np.float32
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=FEATURE_RTOL * np.abs(theirs[k]).max())
    # a second call reads the cache, whatever the clouds
    again = port.evaluate([c[::-1] for c in real], gen, ("frd", "jsd"))
    assert again["frd"] == got["frd"] and again["jsd"] == got["jsd"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_cli_matches_the_jax_tool(clouds, tmp_path, monkeypatch):
    real, gen = clouds
    for d, cs in (("real", real), ("gen", gen)):
        (tmp_path / d).mkdir()
        for i, c in enumerate(cs[:2]):
            np.save(tmp_path / d / f"{i}.npy", c)
    np.savetxt(tmp_path / "real" / "2.txt", real[2])
    depth = np.random.RandomState(3).uniform(0.3, 70, (16, 64)).astype(np.float32)
    save_pth_sample(tmp_path / "gen" / "2.pth", depth, np.random.RandomState(4).randn(16, 64, 3) * 20)
    args = ["--real", str(tmp_path / "real"), "--gen", str(tmp_path / "gen"), "-m", "cd", "jsd", "mmd"]
    got = evaluate_cli.main([*args, "-o", str(tmp_path / "port.json"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *args, "-o", str(tmp_path / "jax.json")])
    _tool("evaluate").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    with pytest.raises(RuntimeError, match="CUDA"):  # --device defaults to cuda
        evaluate_cli.main(args)


def test_evaluate_temporal_cli_matches_the_jax_tool(tmp_path, monkeypatch):
    rnd = np.random.RandomState(5)
    infos = []
    for s in range(2):
        seq = tmp_path / "rollouts" / f"seq_{s:04d}"
        seq.mkdir(parents=True)
        base = scan(rnd, 300)[:, :3]
        for i in range(5):
            frame = base + np.array([0.4 * i, 0.1 * i, 0.0], np.float32) + 0.02 * rnd.randn(300, 3)
            np.save(seq / f"frame_{i:03d}.npy", frame.astype(np.float32)[: 300 - 10 * i])
        infos.append([{"lidar2ego_rotation": [1.0, 0, 0, 0], "lidar2ego_translation": [0.9, 0.0, 1.8],
                       "ego2global_rotation": [np.cos(0.01 * i), 0, 0, np.sin(0.01 * i)],
                       "ego2global_translation": [100.0 + 0.4 * i, 0.1 * i, 0.0]} for i in range(5)])
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    common = ["--gen-dir", str(tmp_path / "rollouts"), "--max-points", "250"]
    runs = (["-m", "tcd", "--global-frame"], ["-m", "ttce", "tcd", "--infos", str(tmp_path / "infos.pkl")])
    for i, extra in enumerate(runs):
        got = temporal_cli.main([*common, *extra, "-o", str(tmp_path / f"port{i}.json"), "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["evaluate_temporal.py", *common, *extra, "-o", str(tmp_path / f"jax{i}.json")])
        _tool("evaluate_temporal").main()
        want = json.loads((tmp_path / f"jax{i}.json").read_text())
        assert json.loads((tmp_path / f"port{i}.json").read_text()) == got
        assert {m: list(v) for m, v in got.items()} == {m: list(v) for m, v in want.items()}
        for m in want:
            for split in want[m]:
                np.testing.assert_allclose(got[m][split], want[m][split], rtol=RTOL, atol=1e-7, err_msg=f"{m} {split}")
    with pytest.raises(RuntimeError, match="CUDA"):
        temporal_cli.main(common)


def test_sample_files_read_as_the_jax_package_reads_them(tmp_path):
    from lidarcrafter_tpu.utils import sample_io as J
    from lidarcrafter_tpu_torch.utils import sample_io as T

    rnd = np.random.RandomState(6)
    depth = rnd.uniform(0.2, 80, (8, 32)).astype(np.float32)
    T.save_pth_sample(tmp_path / "a.pth", depth, rnd.randn(8, 32, 3), rnd.rand(8, 32))
    np.save(tmp_path / "b.npy", rnd.randn(10, 4).astype(np.float32))
    np.savetxt(tmp_path / "c.txt", rnd.randn(7, 3))
    rnd.randn(12, 5).astype(np.float32).tofile(tmp_path / "d.bin")
    files = T.list_sample_files(tmp_path)
    assert files == J.list_sample_files(tmp_path) and len(files) == 4
    assert T.list_sample_files(tmp_path, limit=2) == files[:2]
    for f in files:
        np.testing.assert_array_equal(T.load_point_file(f), J.load_point_file(f))
    img = T.load_pth_image(tmp_path / "a.pth")
    for kw in ({}, {"keep_zeros": True}, {"resolution": (4, 16)}):
        np.testing.assert_array_equal(T.pth_to_points(img, **kw), J.pth_to_points(img, **kw))
