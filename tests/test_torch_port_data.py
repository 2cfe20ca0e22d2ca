"""The port's training data path against the JAX package's, on the CPU, on
the same nuScenes-format files (``utils/synthetic.py::write_nuscenes_tree``:
2 scenes of 4 frames a split, 6,000-point clouds at uniform random angles
and depths, foreground points in the central 80% of their boxes).

(a) ``NuscDataset`` for each of its four tasks (``None``,
    ``layout_generation``, ``layout_cond`` with ``delete_ground``,
    ``autoregressive_generation``) on the train and val splits, and the
    shuffled ``all`` split: every sample, then a collated batch
    (``collate_fn``; ``collate_scene_graphs`` for the layout task).  Each
    port sample draws from generators seeded ``sample_seed(0, 0, i)``; the
    JAX globals (``random``, ``np.random``, the assigner's ``rng``) are
    seeded with the same seed right before its ``ds[i]``.  Keys, dtypes and
    shapes equal; integer, boolean and string fields exactly; float32 to
    1e-6 absolute plus one float32 ulp of the value (the JAX route's C++
    projection and XLA round a depth or an ``exp`` an ulp away from torch);
    the projected pixels' winners (their x, y, z) exactly: no pixel may
    differ.
(b) ``NuscTempDataset``'s (H, W, 7) ``prev_cond`` with its label channel,
    ``NuscObjectDataset`` with the resample of an object too sparse to
    train, and ``CustomDataset``, to the same limits.
(c) The augmentor's flips, rotation and scaling, ``GTDatabaseSampler`` and
    ``DataAugmentor`` with equal seeds: exactly where the JAX functions are
    numpy, 1e-6 where they rotate.
(d) ``PrefetchLoader`` at 0 / 1 / 3 workers with scrambled completion
    equal to the synchronous stream and to the JAX loader's, and on the
    random train split of the autoregressive task (prev-frame depth, depth
    noise) equal at 0 and 3 workers.
(e) One ``Trainer`` step of the reduced ``nuscenes-box-layout-v6`` on a
    batch from these files against the JAX ``Trainer.prepare_batch`` and
    ``make_train_step`` on the same batch, weights and draws: the prepared
    inputs to 1e-6, the loss to 1e-5 relative, the gradients as
    ``test_torch_port_train.py`` holds them.
"""

import random
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_train import _assert_grads, _capture, _state_dicts, jax_draws
from torch_port_harness import Pair, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu import datasets as jdatasets
from lidarcrafter_tpu.datasets import augmentor as jaug
from lidarcrafter_tpu.datasets.scene_graph import collate_scene_graphs as j_collate_scene_graphs
from lidarcrafter_tpu.native.loader import PrefetchLoader as JPrefetchLoader
from lidarcrafter_tpu.training.loop import Trainer as JTrainer
from lidarcrafter_tpu.training.optim import make_optimizer as j_make_optimizer
from lidarcrafter_tpu.training.state import TrainState as JState
from lidarcrafter_tpu.training.train_step import make_train_step as j_make_train_step
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import datasets as tdatasets
from lidarcrafter_tpu_torch.datasets import augmentor as taug
from lidarcrafter_tpu_torch.datasets.loader import PrefetchLoader
from lidarcrafter_tpu_torch.datasets.nuscenes import sample_seed
from lidarcrafter_tpu_torch.datasets.scene_graph import collate_scene_graphs
from lidarcrafter_tpu_torch.training.loop import Trainer
from lidarcrafter_tpu_torch.training.optim import AdamW
from lidarcrafter_tpu_torch.training.state import TrainState, named_module_params
from lidarcrafter_tpu_torch.utils.synthetic import point_config_at_tree, text_features, write_nuscenes_tree
from lidarcrafter_tpu_torch.weights import load_flax_params

POINTS = 6000
ULP = 2.0**-23  # one float32 ulp, relative


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_nuscenes_tree(tmp_path_factory.mktemp("nusc"), num_points=POINTS)


def datasets(name: str, tree: dict, split: str, dataset: str | None = None, cfgs=None, seed: int = 0):
    """The JAX and the port dataset of config ``name`` on ``tree``."""
    jcfg, tcfg = cfgs or (jcfgs.get_config(name), tcfgs.get_config(name))
    for cfg in (jcfg, tcfg):
        point_config_at_tree(cfg, tree, split)
        if dataset:
            cfg.data.dataset = dataset
    random.seed(seed)  # the JAX datasets shuffle with the global generator
    jds = jdatasets.__all_datasets__[jcfg.data.dataset](jcfg)
    return jds, tdatasets.make_dataset(tcfg, seed=seed)


def jax_sample(jds, i: int, seed: int):
    """The JAX ``ds[i]`` with its global draws seeded ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    if hasattr(jds, "scene_graph_assigner"):
        jds.scene_graph_assigner.rng = np.random.RandomState(seed)
    return jds[i]


def assert_same(got, want, where: str = ""):
    """Equal structure; ints, bools and strings exactly, float32 to 1e-6
    plus one ulp; a range image's winners (xyz) exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
        if "xyz" in want:
            flipped = np.any(np.asarray(got["xyz"]) != np.asarray(want["xyz"]), axis=-1)
            assert int(flipped.sum()) == 0, (where, int(flipped.sum()))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, (where, got.shape, want.shape, got.dtype,
                                                                    want.dtype)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=ULP, atol=1e-6, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


TASKS = ("nuscenes-unet-uncond", "nuscenes-layout", "nuscenes-box-layout-v6", "nuscenes-auto-reg-v2")


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", TASKS)
def test_nusc_dataset_matches_jax(tree, name, split):
    jds, tds = datasets(name, tree, split)
    assert len(tds) == len(jds) > 2
    got, want = [], []
    for i in range(len(tds)):
        s = sample_seed(0, 0, i)
        got.append(tds.sample(i, s))
        want.append(jax_sample(jds, i, s))
        assert_same(got[-1], want[-1], f"{name} {split} sample {i}")
    if tds.task == "layout_generation":
        encode = text_features
        assert_same(collate_scene_graphs(got[:3], text_encode_fn=encode),
                    j_collate_scene_graphs(want[:3], text_encode_fn=encode), "collated")
        if split == "train":  # the edits drawn from the seeded generators
            assert {g["manipulate"]["type"] for g in got} - {"none"}
    else:
        batch = tds.collate_fn(got[:3])
        assert_same(batch, jds.collate_fn(want[:3]), "collated")
        assert all(v.dtype == np.float32 for k, v in batch.items() if k not in tds.NON_STACK_KEYS
                   and k != "batch_size")
    if tds.task == "autoregressive_generation":
        assert all(g["is_valid_obj"].sum() > 0 for g in got)
        if split == "train":  # the depth noise is drawn: no two samples of a frame are alike
            s = sample_seed(0, 1, 0)
            assert not np.array_equal(tds.sample(0, s)["autoregressive_cond"], got[0]["autoregressive_cond"])


def test_all_split_shuffles_like_jax(tree):
    jds, tds = datasets("nuscenes-unet-uncond", tree, "all", seed=4)
    tokens = [d["token"] for d in tds.data]
    assert tokens == [d["token"] for d in jds.data] and tokens != sorted(tokens)
    # as in the JAX dataset, ``all`` turns the path to the val pickle before
    # it reads "train" and "val" from it, so it reads val twice
    assert len(tokens) == 16 and {t.split("_")[0] for t in tokens} == {"val"}
    assert_same(tds.sample(3, 9), jax_sample(jds, 3, 9), "all split")


def test_temporal_dataset_matches_jax(tree):
    jds, tds = datasets("nuscenes-unet-uncond", tree, "train", dataset="nuscenes-temporal")
    assert len(tds) == len(jds) == 6  # the frames with a previous frame
    for i in range(len(tds)):
        got = tds[i]
        assert got["prev_cond"].shape == (32, 1024, 7)
        assert (got["prev_cond"][..., 4] > 0).sum() > 100  # labelled foreground pixels
        assert_same(got, jds[i], f"temporal {i}")


def test_object_dataset_matches_jax_with_resample(tree):
    jds, tds = datasets("nuscenes-object", tree, "train", seed=3)
    assert [o["path"] for o in tds.data] == [o["path"] for o in jds.data]
    sparse = [i for i, o in enumerate(tds.data) if o["num_points_in_gt"] < 50]
    assert sparse and len(sparse) < len(tds)
    got, want = [], []
    for i in range(len(tds)):
        s = sample_seed(0, 0, i)
        got.append(tds.sample(i, s))
        want.append(jax_sample(jds, i, s))
        assert_same(got[-1], want[-1], f"object {i}")
    assert_same(tds.collate_fn(got), jds.collate_fn(want), "collated")
    assert got[0]["fg_points"].shape == (1024, 4)


def test_custom_dataset_matches_jax(tree):
    cloud = np.fromfile(f"{tree['data_root']}/samples/train_00_01.bin", np.float32).reshape(-1, 5)[:, :4]
    boxes = np.zeros((3, 7), np.float32)
    boxes[1:] = [[10, 5, 0, 4, 2, 2, 0.3], [-15, 2, 0, 3, 2, 2, 1.0]]
    info = {"points": cloud, "gt_boxes": boxes, "gt_names": ["ego", "car", "truck"]}
    got = tdatasets.CustomDataset(custom_box_infos=[info])[0]
    assert got["is_valid_obj"].sum() == 2
    assert_same(got, jdatasets.CustomDataset(custom_box_infos=[info])[0], "custom")


# ------------------------------------------------------------------ (c)


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    boxes = rng.randn(5, 9)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 1
    return boxes, rng.randn(100, 4)


@pytest.mark.parametrize("fn", ["random_flip_along_x", "random_flip_along_y"])
def test_flips_match_jax(fn):
    for enable in (None, True):
        b, p = _scene()
        got = getattr(taug, fn)(b.copy(), p.copy(), enable=enable, rng=np.random.RandomState(2))
        want = getattr(jaug, fn)(b.copy(), p.copy(), enable=enable, rng=np.random.RandomState(2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_rotation_and_scaling_match_jax():
    b, p = _scene(1)
    got = taug.global_rotation(b.copy(), p.copy(), [-0.4, 0.4], rng=np.random.RandomState(5))
    want = jaug.global_rotation(b.copy(), p.copy(), [-0.4, 0.4], rng=np.random.RandomState(5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    got = taug.global_scaling(b.copy(), p.copy(), [0.9, 1.1], rng=np.random.RandomState(5))
    want = jaug.global_scaling(b.copy(), p.copy(), [0.9, 1.1], rng=np.random.RandomState(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert taug.global_scaling(b.copy(), p.copy(), [1.0, 1.0])[2] == 1.0


def _database(seed=0):
    """Cars at the origin (colliding with the scene box) and far away."""
    rng = np.random.RandomState(seed)
    db = {"car": [], "truck": []}
    for k in range(12):
        name = "car" if k % 2 else "truck"
        centre = [0.5 * rng.rand(), 0, 0] if k % 3 == 0 else [rng.uniform(-40, 40), rng.uniform(-40, 40), 0]
        db[name].append({"box3d_lidar": np.array([*centre, 4, 2, 2, rng.uniform(-3, 3)]),
                         "num_points_in_gt": int(rng.randint(2, 100)),
                         "points": (rng.randn(20, 4) * 0.3).astype(np.float32)})
    return db


def test_gt_sampler_matches_jax():
    db = _database()
    scene = {"gt_boxes": np.array([[0, 0, 0, 4, 2, 2, 0.0]]), "gt_names": np.array(["car"]),
             "points": np.random.RandomState(1).randn(300, 4) * 20}
    got = taug.GTDatabaseSampler(db, ["car", "truck"], {"car": 4, "truck": 3}, rng=np.random.RandomState(3))(
        {k: v.copy() for k, v in scene.items()})
    want = jaug.GTDatabaseSampler(db, ["car", "truck"], {"car": 4, "truck": 3}, rng=np.random.RandomState(3))(
        {k: v.copy() for k, v in scene.items()})
    assert 1 < len(got["gt_boxes"]) < 8  # some placed, some rejected
    for k in ("gt_boxes", "points", "gt_names"):
        np.testing.assert_array_equal(got[k], want[k])


def test_data_augmentor_matches_jax():
    config = [{"name": "gt_sampling", "sample_groups": {"car": 3, "truck": 2}},
              {"name": "random_world_flip", "along_axis_list": ["x", "y"]},
              {"name": "random_world_rotation", "rot_range": [-0.4, 0.4]},
              {"name": "random_world_scaling", "scale_range": [0.95, 1.05]}]
    db = _database(1)
    b, p = _scene(2)
    outs = []
    for aug in (taug, jaug):
        a = aug.DataAugmentor(config, ["car", "truck"], rng=np.random.RandomState(7), db_infos=db)
        outs.append(a({"gt_boxes": b.copy(), "points": p.copy() * 20, "gt_names": np.array(["car"] * 5)}))
    got, want = outs
    assert (np.abs(got["gt_boxes"][:, 6]) <= np.pi).all()
    for k in ("gt_boxes", "points"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    np.testing.assert_array_equal(got["gt_names"], want["gt_names"])
    with pytest.raises(ValueError):
        taug.DataAugmentor([{"name": "nope"}], ["car"])


# ------------------------------------------------------------------ (d)


class _FakeDS:
    """Samples of their own index; odd ones sleep so that threads finish
    out of order."""

    def __init__(self, n=13):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i % 2:
            time.sleep(0.005)
        return {"x": np.full((2,), float(i), np.float32)}

    @staticmethod
    def collate_fn(samples):
        return {"x": np.stack([s["x"] for s in samples])}


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_prefetch_loader_matches_sync_and_jax(workers):
    ds, B, seed = _FakeDS(), 4, 5
    got = iter(PrefetchLoader(ds, B, num_workers=workers, queue_depth=3, seed=seed))
    got = [next(got)["x"] for _ in range(7)]
    rng, want = np.random.RandomState(seed), []
    while len(want) < 7:
        order = rng.permutation(len(ds))
        want += [ds.collate_fn([ds[int(j)] for j in order[i: i + B]])["x"] for i in range(0, len(order) - B + 1, B)]
    jax_stream = iter(JPrefetchLoader(ds, B, num_workers=max(workers, 1), queue_depth=3, seed=seed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, next(jax_stream)["x"])
    with pytest.raises(ValueError):
        PrefetchLoader(_FakeDS(n=3), batch_size=4)


def test_prefetch_loader_random_split_is_the_same_at_0_and_3_workers(tree):
    _, tds = datasets("nuscenes-auto-reg-v2", tree, "train")
    streams = [iter(PrefetchLoader(tds, 2, num_workers=w, queue_depth=2, seed=1)) for w in (0, 3)]
    for _ in range(4):  # over an epoch boundary (6 samples, 3 batches an epoch)
        a, b = (next(s) for s in streams)
        assert a["token"] == b["token"]
        for k in ("autoregressive_cond", "depth", "condition_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    assert torch.get_num_threads() == 1  # the workers' one-thread setting stays in the workers


# ------------------------------------------------------------------ (e)


def test_trainer_step_from_files_matches_jax(tree, monkeypatch):
    pair = Pair("nuscenes-box-layout-v6", small=True, batch_size=2)
    for cfg in (pair.jcfg, pair.tcfg):
        t = cfg.training
        t.lr, t.lr_warmup_steps, t.num_steps, t.ema_update_every, t.mixed_precision = 1e-3, 2, 10, 1, "no"
    jds, tds = datasets("nuscenes-box-layout-v6", tree, "train", cfgs=(pair.jcfg, pair.tcfg))
    seeds = [sample_seed(0, 0, i) for i in (1, 4)]
    batch = tds.collate_fn([tds.sample(i, s) for i, s in zip((1, 4), seeds)])
    jraw = jds.collate_fn([jax_sample(jds, i, s) for i, s in zip((1, 4), seeds)])

    trainer = Trainer(pair.tcfg, iter(()), log_fn=None, device="cpu")
    for k, m in trainer.models.items():
        load_flax_params(m, pair.params[k])
    prepared = trainer.prepare_batch(batch)
    jprepared = JTrainer.prepare_batch(SimpleNamespace(cfg=pair.jcfg, lidar_utils=pair.jlu, is_cond=True), jraw)
    for k in ("x_0", "concat_cond", "autoregressive_cond", "scaled_gt_boxes", "gt_boxes_2d", "is_valid_obj"):
        if k in jprepared:
            np.testing.assert_allclose(prepared[k].numpy(), np.asarray(jprepared[k]), rtol=ULP, atol=1e-6, err_msg=k)
    assert "concat_cond" in prepared and prepared["x_0"].shape == (2, 32, 128, 2)

    key = jax.random.PRNGKey(7)
    t_draw, noise, _ = jax_draws(key, 0, tuple(prepared["x_0"].shape))
    names = [n for n, _ in named_module_params(trainer.models)]
    grads, update = {}, AdamW.update_

    def capture(opt, trained, g, opt_state):
        grads.update((n, x.clone()) for n, x in zip(names, g))
        update(opt, trained, g, opt_state)

    monkeypatch.setattr(AdamW, "update_", capture)
    _, loss = trainer.step_fn(TrainState.create(trainer.models, trainer.optimizer), prepared, 0, t=t_draw,
                              noise=noise)
    tx = optax.chain(_capture(), j_make_optimizer(lr=1e-3, warmup_steps=2, num_steps=10))
    jstep = j_make_train_step(pair.jengine, tx, donate=False, ema_update_every=1, ema_update_after_step=2)
    jstate, jloss = jstep(JState.create(pair.params, tx), {k: jnp.asarray(v) for k, v in jprepared.items()}, key)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads(grads, _state_dicts(jstate.opt_state[0], trainer.models))
