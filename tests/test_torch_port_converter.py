"""The data-pipeline converters and the HD-map geometry core of the PyTorch
port (``datasets/converter.py``, ``datasets/map_extractor.py``,
``converters/``; host numpy copies) against the JAX package's, on the same
seeded inputs: every output equal bit for bit.  Mirrors
``tests/test_converter.py`` test for test, each case over several seeds;
the devkit steps run on the same fake devkit object; the two CLIs that need
no devkit run on the same files."""

import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

from lidarcrafter_tpu.datasets import converter as JC
from lidarcrafter_tpu.datasets import map_extractor as JM
from lidarcrafter_tpu_torch.converters import add_lidarseg, nuscenes_converter, split_object_dataset
from lidarcrafter_tpu_torch.datasets import converter as TC
from lidarcrafter_tpu_torch.datasets import map_extractor as TM

REPO = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 2)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_converter_{name}", REPO / "tools" / "converters" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(a, b):
    """Equal structure and values, arrays bit for bit with their dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _quat(rng):
    q = rng.standard_normal(4)
    return q / np.linalg.norm(q)


def test_tables_equal():
    assert TC.NUSC_NAME_MAPPING == JC.NUSC_NAME_MAPPING and TC.MAP_CLASSES == JC.MAP_CLASSES
    assert TM.MAP_LOCATIONS == JM.MAP_LOCATIONS


@pytest.mark.parametrize("seed", SEEDS)
def test_quaternion_to_matrix_yaw(seed):
    rng = np.random.RandomState(seed)
    q = _quat(rng)
    same(TC.quaternion_to_matrix(q), JC.quaternion_to_matrix(q))
    same(TC.quaternion_to_matrix(np.zeros(4)), JC.quaternion_to_matrix(np.zeros(4)))
    xyzw = list(_quat(rng))
    same(TC.quart_to_rpy(xyzw), JC.quart_to_rpy(xyzw))
    utimes = np.sort(rng.uniform(0, 100, 20))
    for t in (-1.0, 0.0, *rng.uniform(0, 100, 5), 200.0):
        same(TC.locate_message(utimes, t), JC.locate_message(utimes, t))


@pytest.mark.parametrize("seed", SEEDS)
def test_velocity_global_to_lidar_inverts_rotations(seed):
    rng = np.random.RandomState(seed)
    v = rng.standard_normal((7, 2))
    e2g, l2e = (JC.quaternion_to_matrix(_quat(rng)) for _ in range(2))
    same(TC.velocity_global_to_lidar(v, e2g, l2e), JC.velocity_global_to_lidar(v, e2g, l2e))


@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_gt_boxes_reorders_dims(seed):
    rng = np.random.RandomState(seed)
    args = rng.standard_normal((5, 3)), rng.uniform(1, 5, (5, 3)), rng.uniform(-3, 3, 5)
    same(TC.assemble_gt_boxes(*args), JC.assemble_gt_boxes(*args))


@pytest.mark.parametrize("seed", SEEDS)
def test_classify_motion_thresholds(seed):
    rng = np.random.RandomState(seed)
    trajs = [rng.standard_normal((6, 2)) * s for s in (0.1, 1.0, 3.0)] + [np.zeros((0, 2)), np.zeros((6, 2))]
    for t in trajs:
        same(TC.classify_motion(t), JC.classify_motion(t))
        same(TC.classify_motion(t, 1.0, 0.2), JC.classify_motion(t, 1.0, 0.2))


@pytest.mark.parametrize("seed", SEEDS)
def test_agent_future_offsets_roundtrip(seed):
    rng = np.random.RandomState(seed)
    center = rng.standard_normal(3) * 10
    for T in (0, 3, 8):
        scene = rng.standard_normal((T, 2)) * 10
        same(TC.agent_future_offsets(scene, center, 6), JC.agent_future_offsets(scene, center, 6))


@pytest.mark.parametrize("seed", SEEDS)
def test_local_to_global_then_offsets(seed):
    rng = np.random.RandomState(seed)
    local, center, R = rng.standard_normal((6, 2)), rng.standard_normal(3), JC.quaternion_to_matrix(_quat(rng))
    same(TC.local_coords_to_global(local, center, R), JC.local_coords_to_global(local, center, R))


@pytest.mark.parametrize("seed", SEEDS)
def test_ego_future_to_lidar_straight(seed):
    rng = np.random.RandomState(seed)
    glob = np.cumsum(rng.standard_normal((7, 3)) * [2.0, 2.0, 0.1], axis=0)
    args = glob, rng.standard_normal(3), _quat(rng), rng.standard_normal(3), _quat(rng)
    same(TC.ego_future_to_lidar(*args), JC.ego_future_to_lidar(*args))


def test_geom2anno_labels():
    class Line:
        def __init__(self, c):
            self.coords = c

    geoms = {"divider": [np.zeros((3, 2)), Line([(0.0, 1.0), (2.0, 3.0)])], "ped_crossing": [],
             "boundary": [np.ones((4, 2))], "ignored": [1]}
    same(TC.geom2anno(geoms), JC.geom2anno(geoms))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_object_dataset(seed):
    rng = np.random.RandomState(seed)
    db = {name: [{"num_points_in_gt": int(n), "cls": name, "i": i} for i, n in enumerate(rng.randint(0, 200, 40))]
          for name in ("car", "truck", "bus", "pedestrian", "barrier")}
    kw = dict(sample_num=20, min_points=50, seed=seed)
    same(TC.split_object_dataset(db, **kw), JC.split_object_dataset(db, **kw))


def test_split_object_dataset_cli(tmp_path):
    """The port's CLI and the JAX tool write the same two pickles."""
    rng = np.random.RandomState(4)
    db = {name: [{"num_points_in_gt": int(n), "i": i} for i, n in enumerate(rng.randint(0, 200, 30))]
          for name in ("car", "bus", "pedestrian")}
    src = tmp_path / "dbinfos.pkl"
    src.write_bytes(pickle.dumps(db))
    split_object_dataset.main(["--dbinfos", str(src), "-o", str(tmp_path / "port"), "--sample-num", "12"])
    tool = _jax_tool("split_object_dataset")
    import sys

    argv = sys.argv
    sys.argv = ["split_object_dataset.py", "--dbinfos", str(src), "-o", str(tmp_path / "jax"), "--sample-num", "12"]
    try:
        tool.main()
    finally:
        sys.argv = argv
    for name in ("nuscenes_object_classification_train.pkl", "nuscenes_object_classification_val.pkl"):
        same(pickle.loads((tmp_path / "port" / name).read_bytes()), pickle.loads((tmp_path / "jax" / name).read_bytes()))


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_orientation(seed):
    rng = np.random.RandomState(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
    ring = np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(1, 3, (7, 1))
    ring = np.vstack([ring, ring[:1]])
    for r in (ring, ring[::-1]):
        same(TM.signed_area(r), JM.signed_area(r))
        same(TM.is_ccw(r), JM.is_ccw(r))
        for ccw in (True, False):
            same(TM.ensure_orientation(r, ccw), JM.ensure_orientation(r, ccw))


@pytest.mark.parametrize("seed", SEEDS)
def test_clip_polyline_to_box(seed):
    rng = np.random.RandomState(seed)
    lines = [rng.uniform(-2, 3, (n, 2)) for n in (2, 5, 12)] + [np.array([[5.0, 5], [6, 6]])]
    for line in lines:
        same(TM.clip_polyline_to_box(line, 0, 0, 1, 1), JM.clip_polyline_to_box(line, 0, 0, 1, 1))


@pytest.mark.parametrize("seed", SEEDS)
def test_rect_direction_and_groups(seed):
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, np.pi)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    rect = (rng.rand(200, 2) * [6.0, 1.0]) @ R.T
    same(TM.rect_direction(rect), JM.rect_direction(rect))
    dirs = [(np.array([np.cos(a), np.sin(a)]), float(n)) for a, n in zip(rng.uniform(0, 3, 6), rng.uniform(1, 5, 6))]
    same(TM.aligned_groups(dirs), JM.aligned_groups(dirs))


def test_map_extractor_is_gated_as_in_jax():
    for mod in (TM, JM):
        with pytest.raises(ImportError, match="shapely"):
            mod.NuscMapExtractor("nowhere", (60, 30))


class FakeNusc:
    def get(self, table, token):
        if table == "sample":
            return {"data": {"LIDAR_TOP": f"sd_{token}"}}
        assert table == "lidarseg"
        if token == "sd_tok_nolabel":
            return None
        return {"filename": f"lidarseg/{token}.bin"}


def test_add_lidarseg_patch():
    """``gt_segment_path`` patching on a fake devkit object, as the JAX
    tool patches: the same infos and counts, list and dict-wrapped."""
    jax_patch = _jax_tool("add_lidarseg").patch_infos_with_lidarseg
    for make in (lambda: [{"token": "tok_a"}, {"token": "tok_nolabel"}, {"token": "tok_b"}],
                 lambda: {"infos": [{"token": "tok_c"}, {"token": "tok_nolabel"}]}):
        got, want = make(), make()
        same(add_lidarseg.patch_infos_with_lidarseg(got, FakeNusc()), jax_patch(want, FakeNusc()))
        same(got, want)


@pytest.mark.parametrize("main", [nuscenes_converter.main, add_lidarseg.main])
def test_devkit_steps_are_gated(main, tmp_path):
    """Without the nuScenes devkit the devkit steps stop with the reason,
    as the JAX tools do."""
    args = ["--root", str(tmp_path)] + (["--infos", "x.pkl"] if main is add_lidarseg.main else [])
    with pytest.raises(SystemExit, match="devkit"):
        main(args)
