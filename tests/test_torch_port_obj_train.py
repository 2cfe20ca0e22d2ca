"""The auxiliary trainers of the PyTorch port against the JAX package, on the
CPU, and the object / R2DM evaluation CLIs end to end.

- optax's one-cycle and cosine-decay schedules, the warmup / decay LR, SGD
  with weight decay and the GLENet AdamW against optax;
- 3 train steps of PointMLP (64 points, embed 8, two stages, k = 8,
  dropout 0), GLENet (latent 3, the JAX draws injected; float64 on both
  sides) and RangeNet-21 at 16×64 (its BatchNorm statistics trained as
  weights): every parameter and running statistic 1e-4 of its largest
  value;
- the weighted pixel cross-entropy and ``mean_iou`` (NaN for absent
  classes), the lidarseg dataset's items (labels and masks exactly, floats
  to one ulp);
- ``train_pointmlp`` / ``train_glenet`` / ``train_rangenet`` with their
  synthetic data, their checkpoints read back by ``evaluate_our``, and
  ``evaluate_our`` / ``evaluate_r2dm`` against the JAX tools on the
  metrics that do not depend on the random extractors (BEV JSD / MMD,
  chamfer, DCF).
"""

import importlib.util
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.datasets import seg_dataset as JSD
from lidarcrafter_tpu.metrics.extractor import pointmlp as JPM
from lidarcrafter_tpu.metrics.extractor import rangenet as JRN
from lidarcrafter_tpu.metrics.models import glenet as JGL
from lidarcrafter_tpu.training import classifier as JCL
from lidarcrafter_tpu.training import segmentation as JSG
from lidarcrafter_tpu_torch import evaluate_our, evaluate_r2dm, train_glenet, train_pointmlp, train_rangenet
from lidarcrafter_tpu_torch.datasets import seg_dataset as TSD
from lidarcrafter_tpu_torch.metrics.extractor import pointmlp as TPM
from lidarcrafter_tpu_torch.metrics.extractor import rangenet as TRN
from lidarcrafter_tpu_torch.metrics.models import glenet as TGL
from lidarcrafter_tpu_torch.training import classifier as TCL
from lidarcrafter_tpu_torch.training import optim as TO
from lidarcrafter_tpu_torch.training import segmentation as TSG
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, load_flax_params

REPO = Path(__file__).resolve().parent.parent
STEP_RTOL, LOSS_RTOL = 1e-4, 1e-5
SMALL_MLP = dict(points=64, embed_dim=8, dim_expansion=(2, 2), pre_blocks=(1, 1), pos_blocks=(1, 1),
                 k_neighbors=(8, 8), reducers=(2, 2), dropout=0.0)
LATENT = 3


def close(got, want, rtol: float, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()), err_msg=what)


def same_state(module, variables, rtol, moved_from=None) -> None:
    """Every tensor of ``module``'s state_dict against the flax variables;
    with ``moved_from`` (a state_dict) also that most parameters moved."""
    want = flax_to_state_dict(variables, module)
    got = module.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        close(got[k], v.numpy(), rtol, k)
    if moved_from is not None:
        moved = [k for k in want if not torch.equal(moved_from[k], got[k])]
        assert len(moved) > len(want) // 2, moved


# --------------------------------------------------------------- optimizers


def test_schedules_match_optax():
    for T in (7, 50):
        want = optax.cosine_onecycle_schedule(T, 0.003, pct_start=0.4, div_factor=10.0)
        got = TO.cosine_onecycle_schedule(T, 0.003, pct_start=0.4, div_factor=10.0)
        close([got(i) for i in range(T + 3)], [float(want(i)) for i in range(T + 3)], 1e-6)
    want = optax.cosine_decay_schedule(0.1, 30, alpha=0.05)
    got = TO.cosine_decay_schedule(0.1, 30, alpha=0.05)
    close([got(i) for i in range(35)], [float(want(i)) for i in range(35)], 1e-6)
    want, got = JSG.warmup_exp_decay_schedule(0.01, 5, 0.99), TSG.warmup_exp_decay_schedule(0.01, 5, 0.99)
    close([got(i) for i in range(20)], [float(want(i)) for i in range(20)], 1e-6)


@pytest.mark.parametrize("which", ["classifier", "rangenet", "glenet"])
def test_optimizers_match_optax(which):
    """Five updates of random gradients (the GLENet ones large enough to
    clip) against the JAX package's optimizer."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    if which == "classifier":
        jtx, ttx = JCL.make_classifier_optimizer(epochs=4), TCL.make_classifier_optimizer(epochs=4)
    elif which == "rangenet":
        jtx, ttx = JSG.make_rangenet_optimizer(warmup_steps=2), TSG.make_rangenet_optimizer(warmup_steps=2)
    else:
        jtx, ttx = JGL.make_glenet_optimizer(total_steps=5), TGL.make_glenet_optimizer(total_steps=5)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    tstate = ttx.init(tp)
    for _ in range(5):
        grads = [(rng.randn(*s) * 5).astype(np.float32) for s in shapes]
        updates, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ttx.update_(tp, [torch.as_tensor(g) for g in grads], tstate)
    for a, b in zip(tp, jp):
        close(a, b, 1e-6)
    assert not np.allclose(np.asarray(jp[0]), params[0])


# -------------------------------------------------------------- train steps


def test_classifier_train_steps_match_jax():
    """3 PointMLP steps (dropout 0, 32 clouds): loss and accuracy each step,
    then every parameter and running statistic."""
    jm, tm = JPM.point_mlp(4, **SMALL_MLP), TPM.point_mlp(4, **SMALL_MLP)
    rng = np.random.RandomState(1)
    # the trainer's batch of 32: at 6 clouds the head's batch statistics
    # amplify float32 rounding chaotically (1e-6 after one step, 6e-4 after
    # three at lr 0.1), at 32 the steps stay within 2e-6
    xs = [rng.randn(32, 64, 3).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 4, 32) for _ in range(3)]
    variables = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(xs[0][:1])), 31)
    load_flax_params(tm, variables)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    jtx, ttx = JCL.make_classifier_optimizer(epochs=3), TCL.make_classifier_optimizer(epochs=3)
    jstate, tstate = jtx.init(variables["params"]), ttx.init(list(tm.parameters()))
    jstep, tstep = JCL.make_classifier_train_step(jm, jtx), TCL.make_classifier_train_step(tm, ttx)
    for x, y in zip(xs, ys):
        variables, jstate, jloss, jacc = jstep(variables, jstate, {"points": jnp.asarray(x),
                                                                   "labels": jnp.asarray(y)}, jax.random.PRNGKey(2))
        loss, acc = tstep(tstate, {"points": torch.as_tensor(x), "labels": torch.as_tensor(y)})
        close(loss, jloss, LOSS_RTOL)
        assert float(acc) == float(jacc)
    same_state(tm, variables, STEP_RTOL, moved_from=start)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_glenet_train_steps_match_jax():
    """3 GLENet steps at latent 3 with the JAX step's draws injected, in
    float64 on both sides: the losses each step, then every parameter and
    running statistic 1e-4.  In float32 the comparison is not defined by
    the model: the biases whose shift reaches a train-mode BatchNorm
    unchanged get no gradient from the loss, only the L2 term's
    1e-4 · b / ‖b‖ and each package's rounding noise, and Adam scales that
    noise to steps of the LR's size (2.8e-3 apart after 3 float32 steps)."""
    kw = dict(TGL.EXP20_KWARGS, latent_size=LATENT)
    jm, tm = JGL.GLENet(**kw), TGL.GLENet(**kw).double()
    rng = np.random.RandomState(2)

    def batch():
        return {"points": rng.randn(6, 64, 3), "text_feat": rng.randn(6, 512), "gt_boxes_input": rng.randn(6, 8),
                "gt_boxes": rng.randn(6, 7) * [1, 1, 1, 0.3, 0.3, 0.3, 2]}

    batches = [batch() for _ in range(3)]
    with jax.enable_x64():
        shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                                {k: jnp.asarray(v, jnp.float32) for k, v in batches[0].items()},
                                                rng=jax.random.PRNGKey(1), train=True))
        variables = f64(random_params(shapes, 32))
        load_flax_params(tm, variables)
        start = {k: v.clone() for k, v in tm.state_dict().items()}
        jtx, ttx = JGL.make_glenet_optimizer(total_steps=3), TGL.make_glenet_optimizer(total_steps=3)
        jstate, tstate = jtx.init(variables["params"]), ttx.init(list(tm.parameters()))
        jstep, tstep = JGL.make_glenet_train_step(jm, jtx), TGL.make_glenet_train_step(tm, ttx)
        for i, b in enumerate(batches):
            key, anneal = jax.random.PRNGKey(40 + i), (i + 1) / 3
            variables, jstate, jmetrics = jstep(variables, jstate, {k: jnp.asarray(v) for k, v in b.items()}, key,
                                                anneal)
            eps = torch.as_tensor(np.array(jax.random.normal(key, (6, LATENT), jnp.float64)))
            metrics = tstep(tstate, {k: torch.as_tensor(v) for k, v in b.items()}, anneal, eps=eps)
            for k in ("loss", "reg", "latent"):
                close(metrics[k], jmetrics[k], LOSS_RTOL, k)
        assert variables["params"]["obj_encoder"]["fc1"]["kernel"].dtype == np.float64
    same_state(tm, variables, STEP_RTOL, moved_from=start)


def test_rangenet_train_steps_match_jax():
    """3 RangeNet-21 steps at 16×64 at the trainer's LR (0.01, warmup 1),
    void ignored, the BatchNorm statistics trained with the weights as the
    JAX trainer trains them.  (At lr 0.05 this untrained net diverges by
    the third step, its loss 16 → 446, and float32 rounding then parts the
    two packages by 4e-4.)"""
    jm, tm = JRN.RangeNet(num_classes=17, backbone=21), TRN.RangeNet(num_classes=17, backbone=21)
    rng = np.random.RandomState(3)
    imgs = [rng.rand(2, 16, 64, 5).astype(np.float32) for _ in range(3)]
    labels = [rng.randint(0, 17, (2, 16, 64)).astype(np.int32) for _ in range(3)]
    variables = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 64, 5))), 33)
    load_flax_params(tm, variables)
    TSG.train_frozen_statistics_(tm)
    start = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    jtx, ttx = JSG.make_rangenet_optimizer(warmup_steps=1), TSG.make_rangenet_optimizer(warmup_steps=1)
    jstate, tstate = jtx.init(variables), ttx.init(TSG.trained_tensors(tm))
    jstep = JSG.make_segmentation_train_step(lambda p, x: jm.apply(p, x), jtx, JSG.rangenet_class_weights(17),
                                             ignore_index=0)
    tstep = TSG.make_segmentation_train_step(tm, ttx, TSG.rangenet_class_weights(17), ignore_index=0)
    losses = []
    for img, lab in zip(imgs, labels):
        variables, jstate, jloss = jstep(variables, jstate, {"image": jnp.asarray(img), "labels": jnp.asarray(lab)})
        loss = tstep(tstate, {"image": torch.as_tensor(img.transpose(0, 3, 1, 2).copy()),
                              "labels": torch.as_tensor(lab)})
        close(loss, jloss, LOSS_RTOL)
        losses.append(float(loss))
    assert losses[2] < losses[0]
    same_state(tm, variables, STEP_RTOL, moved_from=start)
    assert any(not torch.equal(start[k], tm.state_dict()[k]) for k in start if k.endswith("running_var"))


def test_pixel_losses_and_mean_iou_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 6, 5, 7).astype(np.float32)  # NHWC, 7 classes
    labels = rng.randint(-1, 5, (2, 6, 5)).astype(np.int32)  # classes 5 and 6 absent
    weights = rng.rand(7).astype(np.float32)
    tl = torch.as_tensor(logits.transpose(0, 3, 1, 2).copy())
    for w in (None, weights):
        close(TSG.weighted_pixel_cross_entropy(tl, torch.as_tensor(labels), None if w is None else torch.as_tensor(w)),
              JSG.weighted_pixel_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), w), LOSS_RTOL)
    for ignore in (-1, 0):
        got = float(TSG.mean_iou(tl, torch.as_tensor(labels), 7, ignore))
        want = float(JSG.mean_iou(jnp.asarray(logits), jnp.asarray(labels), 7, ignore))
        assert got == pytest.approx(want, abs=1e-7)
    # a class in neither the labels nor the prediction is NaN and left out
    one = torch.zeros(1, 3, 1, 2)
    one[0, 1] = 1.0
    assert float(TSG.mean_iou(one, torch.tensor([[[1, 1]]]), 3)) == 1.0
    close(TSG.rangenet_class_weights(17), JSG.rangenet_class_weights(17), 1e-7)


def test_seg_dataset_matches_jax_exactly(tmp_path):
    rng = np.random.RandomState(5)
    np.testing.assert_array_equal(TSD.seg_learning_lut(), JSD.seg_learning_lut())
    infos = []
    for i in range(2):
        N = 800
        pts = np.zeros((N, 5), np.float32)
        ang, r = rng.uniform(-np.pi, np.pi, N), rng.uniform(5, 30, N)
        pts[:, 0], pts[:, 1] = r * np.cos(ang), r * np.sin(ang)
        pts[:, 2], pts[:, 3] = rng.uniform(-2, 4, N), rng.randint(0, 255, N)
        pts.tofile(tmp_path / f"cloud{i}.bin")
        rng.randint(0, 32, N).astype(np.uint8).tofile(tmp_path / f"seg{i}.bin")
        infos.append({"lidar_path": f"cloud{i}.bin", "gt_segment_path": f"seg{i}.bin"})
    infos.append({"lidar_path": "cloud0.bin"})  # no labels: every point labelled 1
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    t = TSD.NuscSegDataset(str(tmp_path / "infos.pkl"), str(tmp_path), resolution=(32, 256))
    j = JSD.NuscSegDataset(str(tmp_path / "infos.pkl"), str(tmp_path), resolution=(32, 256))
    items = [t[i] for i in range(3)]
    for i, item in enumerate(items):
        want = j[i]
        for k in ("segment", "mask"):
            np.testing.assert_array_equal(item[k], want[k], err_msg=f"{i} {k}")
        for k in ("xyz", "reflectance", "depth"):  # a depth may differ in its last bit
            np.testing.assert_array_max_ulp(item[k], want[k], maxulp=1)
    batch = t.collate_fn(items)
    np.testing.assert_array_equal(t.rangenet_input(batch), j.rangenet_input(batch).transpose(0, 3, 1, 2))


# ---------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The three trainer CLIs on their synthetic data, on the CPU."""
    out = tmp_path_factory.mktemp("train")
    mlp = train_pointmlp.main(["--synthetic-data", "--epochs", "4", "--points", "64", "--batch-size", "4",
                               "-o", str(out / "pointmlp"), "--device", "cpu"])
    gle = train_glenet.main(["--synthetic-data", "40", "--folds", "0,1", "--epochs", "2", "--batch-size", "8",
                             "-o", str(out / "glenet"), "--device", "cpu"])
    rn = train_rangenet.main(["--synthetic-data", "--backbone", "21", "--resolution", "16", "64", "-b", "2",
                              "--num-steps", "3", "--warmup-steps", "1", "--eval-every", "3",
                              "--output-dir", str(out / "rangenet"), "--device", "cpu"])
    return out, mlp, gle, rn


def test_trainer_clis_write_checkpoints(trained):
    out, mlp, gle, rn = trained
    assert len(mlp["losses"]) == 4 and np.isfinite(mlp["losses"]).all()
    model = TPM.load_pointmlp(mlp["checkpoint"])
    assert model.cls2.out_features == 4 and not model.training
    assert sorted(gle["history"]) == [0, 1]
    assert all(np.isfinite([r["loss"] for r in rows]).all() for rows in gle["history"].values())
    fold = TGL.load_glenet_fold(out / "glenet" / "fold_1")
    assert fold.latent_size == TGL.EXP20_KWARGS["latent_size"]
    assert len(rn["losses"]) == 3 and np.isfinite(rn["losses"]).all() and len(rn["mious"]) == 1
    assert (Path(rn["checkpoint"]) / "state.pt").exists()
    assert train_glenet.linear_annealing(0, 1, 3, 4) == 0.75 and train_glenet.linear_annealing(0, 1, 5, 0) == 1


def test_trainer_clis_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_pointmlp.main(["--synthetic-data", "--epochs", "1"])


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cloud(r, n=2048):
    return np.concatenate([r.rand(n, 2) * 60 - 30, r.rand(n, 1) * 4 - 2, r.rand(n, 1)], axis=1).astype(np.float32)


def _fg_info(root: Path, r, classes=("car", "truck", "pedestrian"), per_class=4):
    (root / "foreground_samples").mkdir(parents=True, exist_ok=True)
    info = {}
    for cls in classes:
        recs = []
        for i in range(per_class):
            path = root / "foreground_samples" / f"{cls}_{i}.bin"
            ((r.rand(200, 4).astype(np.float32) - 0.5) * 2).tofile(path)
            recs.append({"name": cls, "path": str(path), "num_points_in_gt": int(r.randint(20, 600)),
                         "box3d_lidar": [0, 0, 0, 4.0, 2.0, 1.5, 0.1], "score": 0.5 + 0.1 * i})
        info[cls] = recs
    with open(root / "foreground_samples_info.pkl", "wb") as f:
        pickle.dump(info, f)


def test_evaluate_our_against_the_jax_tool(tmp_path, monkeypatch, trained):
    out, mlp, _, _ = trained
    r = np.random.RandomState(0)
    sample_dir, real_dir = tmp_path / "generated_results", tmp_path / "real"
    real_dir.mkdir()
    (sample_dir / "our").mkdir(parents=True)
    for i in range(3):
        np.save(real_dir / f"r{i}.npy", _cloud(r))
        np.save(sample_dir / "our" / f"g{i}.npy", _cloud(r))
    _fg_info(sample_dir / "our" / "inference_results", r)
    _fg_info(sample_dir / "ori" / "inference_results", r)
    common = ["--method", "our", "--sample-dir", str(sample_dir), "--real-dir", str(real_dir),
              "--num-obj-points", "64", "--mc-passes", "2", "--batch-size", "8"]

    monkeypatch.setattr(sys, "argv", ["evaluate_our.py", *common, "-m", "jsd", "mmd", "cd", "dcf",
                                      "-o", str(tmp_path / "jax.json")])
    _load_tool("evaluate_our").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    for p in (sample_dir / "our" / "inference_results", sample_dir / "ori" / "inference_results"):
        for cache in p.glob("features_*.pkl"):
            cache.unlink()  # the port extracts its own features

    got = evaluate_our.main([*common, "-m", "jsd", "mmd", "cd", "dcf", "cgf", "rgf", "obj", "--random-extractors",
                             "--rgf-folds", "3", "-o", str(tmp_path / "port.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    for section, key in (("bev", "jsd"), ("bev", "mmd"), ("scene", "cd")):
        assert got[section][key] == pytest.approx(want[section][key], rel=1e-5, abs=1e-7), key
    assert got["object"]["dcf"] == want["object"]["dcf"]
    assert got["object"]["cgf"]["overall"]["per_class"].keys() == {"car", "truck", "bus", "pedestrian"}
    assert len(got["object"]["rgf"]["overall"]["variance"]) == 7
    assert set(got["obj"]) == {"frechet_distance", "squared_mmd", "jsd", "mmd"}
    assert all(np.isfinite(v) for v in got["obj"].values())

    # the trainers' checkpoints, and the ori arm (real-set object metrics only)
    res = evaluate_our.main(["--method", "ori", "--sample-dir", str(sample_dir), "-m", "jsd", "dcf", "cgf", "rgf",
                             "--num-obj-points", "64", "--mc-passes", "2", "--pointmlp-ckpt", mlp["checkpoint"],
                             "--glenet-fold-dir", str(out / "glenet"), "--rgf-folds", "2",
                             "-o", str(tmp_path / "ori.json"), "--device", "cpu"])
    assert "bev" not in res and "dcf" not in res["object"]
    assert "cgf" in res["object"] and np.isfinite(res["object"]["rgf"]["overall"]["overlap"])


def test_evaluate_r2dm_against_the_jax_tool(tmp_path, monkeypatch):
    r = np.random.RandomState(1)
    gen_dir, real_dir = tmp_path / "r2dm", tmp_path / "real"
    gen_dir.mkdir()
    real_dir.mkdir()
    for i in range(3):
        depth = (r.rand(8, 64) * 40 + 2).astype(np.float32)
        depth[0, :6], depth[1, :6] = 0.2, 70.0  # outside the depth window
        img = np.concatenate([depth[None], r.randn(3, 8, 64).astype(np.float32) * 15,
                              r.rand(1, 8, 64).astype(np.float32)])
        torch.save(torch.from_numpy(img), gen_dir / f"{i:05d}.pth")
        np.save(real_dir / f"r{i}.npy", _cloud(r, 512))
    img, mask = evaluate_r2dm._gen_image(gen_dir / "00000.pth", 8, 64)
    assert img[0, 0, 0] == 0.0 and img[0, 1, 0] == 0.0 and mask.sum() == 8 * 64 - 12
    args = ["--sample-dir", str(gen_dir), "--real-dir", str(real_dir), "--resolution", "8", "64", "--batch-size", "2"]
    # the JAX tool without extractors: its BEV arm alone (its random
    # extractors would not share the port's weights)
    monkeypatch.setattr(sys, "argv", ["evaluate_r2dm.py", *args, "--cache-dir", str(tmp_path / "jcache"),
                                      "-o", str(tmp_path / "jax.json")])
    _load_tool("evaluate_r2dm").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    # the port with seeded extractors; the image arm's 4096-d FRD features
    # are checked apart (their Fréchet distance is a 4096² eigendecomposition)
    args += ["--random-extractors", "--no-reflectance", "--cache-dir", str(tmp_path / "cache")]
    got = evaluate_r2dm.main([*args, "-o", str(tmp_path / "port.json"), "--device", "cpu"])
    assert got["info"]["#real"] == want["info"]["#real"] == 3 and got["info"]["#fake"] == 3
    for k in ("jsd", "mmd"):
        assert got["bev"][k] == pytest.approx(want["bev"][k], rel=1e-4), k
    assert got["img"] == {} and set(got["pts"]) == {"frechet_distance", "squared_mmd"}
    assert all(np.isfinite(v) for v in got["pts"].values())
    cache = list((tmp_path / "cache").glob("real_set_8x64_*.pkl"))
    assert len(cache) == 1
    stamp = cache[0].stat().st_mtime_ns
    again = evaluate_r2dm.main([*args, "-o", str(tmp_path / "port2.json"), "--device", "cpu"])
    assert cache[0].stat().st_mtime_ns == stamp and again == got  # the real arm came from the cache

    from lidarcrafter_tpu_torch.metrics import pretrained

    feats = evaluate_r2dm._extract((evaluate_r2dm._gen_image(f, 8, 64)[0] for f in sorted(gen_dir.glob("*.pth"))),
                                   pretrained.random_rangenet_lidargen(device="cpu"), None, 2, True, "cpu")
    assert feats["img_feats"].shape == (3, 4096) and np.isfinite(feats["img_feats"]).all()
    assert feats["bev_hists"].shape == (3, 100, 100) and feats["pts_feats"] is None
