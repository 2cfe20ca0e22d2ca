"""The detection side of the sparse 3D stack in the PyTorch port against the
JAX package, on the CPU: the point and stacked-point ops, rotated IoU and
NMS, RoI-aware pooling, the neighbour-voxel pool, the substitute
``VoxelDetector``, pcdet's Voxel R-CNN (CenterHead) with its RoI head and
its pcdet-format reader, the detection metric, and the two CLIs
(``evaluate_detection``, ``extract_foreground``) against the JAX tools run
in-process on the same files.

Limits: indices, masks, NMS keep sets, class names and the upstream reader
bit for bit; ops 1e-5 of the largest output; the detectors 1e-4 of the
largest; AP, recall and extracted objects equal (scores and boxes 1e-4).
Voxel R-CNN runs on the JAX tests' reduced grid (±8 m at 0.1 m, 8,192
voxels; ``tests/test_voxel_rcnn.py``), the CLIs too (both packages'
``load_voxel_rcnn_from_pcdet`` patched to it).
"""

import functools
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
from test_voxel_rcnn import _min_bev_sd, _min_head_sd, _min_roi_sd, _min_sparse_sd
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.metrics import detection_eval as JDE
from lidarcrafter_tpu.metrics.models import detector as JD
from lidarcrafter_tpu.metrics.models import voxel_rcnn as JVR
from lidarcrafter_tpu.models.voxel_pool import NeighborVoxelSAPool as JPool
from lidarcrafter_tpu.ops import iou3d as JI
from lidarcrafter_tpu.ops import points as JP
from lidarcrafter_tpu.ops import roiaware as JR
from lidarcrafter_tpu.ops import stack as JS
from lidarcrafter_tpu.utils.torch_ckpt import convert_voxel_rcnn as jax_convert_voxel_rcnn
from lidarcrafter_tpu_torch import evaluate_detection as eval_det_cli
from lidarcrafter_tpu_torch import extract_foreground as fg_cli
from lidarcrafter_tpu_torch.metrics import detection_eval as TDE
from lidarcrafter_tpu_torch.metrics.models import detector as TD
from lidarcrafter_tpu_torch.metrics.models import voxel_rcnn as TVR
from lidarcrafter_tpu_torch.models.voxel_pool import NeighborVoxelSAPool as TPool
from lidarcrafter_tpu_torch.ops import iou3d as TI
from lidarcrafter_tpu_torch.ops import points as TP
from lidarcrafter_tpu_torch.ops import roiaware as TR
from lidarcrafter_tpu_torch.ops import stack as TS
from lidarcrafter_tpu_torch.utils.torch_ckpt import convert_voxel_rcnn, to_pcdet_state_dict
from lidarcrafter_tpu_torch.weights import load_flax_params

REPO = Path(__file__).resolve().parent.parent
OP_RTOL, MODEL_RTOL = 1e-5, 1e-4
REDUCED = dict(point_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 1.0), voxel_size=(0.1, 0.1, 0.1), max_voxels=8192,
               topk_per_head=8)
TINY_DET = dict(point_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), voxel_size=0.5, max_voxels=512, num_classes=4)


def t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def close(got: torch.Tensor, want, rtol: float, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def exact(got, want, what: str = "") -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def boxes(rnd, n, spread=10.0):
    b = np.concatenate([rnd.uniform(-spread, spread, (n, 2)), rnd.uniform(-1, 1, (n, 1)), rnd.uniform(0.5, 4, (n, 3)),
                        rnd.uniform(-np.pi, np.pi, (n, 1))], 1)
    return b.astype(np.float32)


# ------------------------------------------------------------ point ops


def test_point_ops():
    rnd = np.random.RandomState(0)
    xyz = rnd.uniform(-3, 3, (2, 200, 3)).astype(np.float32)
    xyz[1, 150:] = xyz[1, :50]  # ties in distance
    mask = np.ones((2, 200), bool)
    mask[0, 180:] = False
    new = xyz[:, :40] + 0.1
    exact(TP.farthest_point_sampling(*t(xyz), 32, torch.as_tensor(mask)),
          JP.farthest_point_sampling(jnp.asarray(xyz), 32, jnp.asarray(mask)), "fps")
    for radius, ns in ((0.8, 8), (0.05, 4)):  # 0.05: queries with no hit
        exact(TP.ball_query(*t(new, xyz), radius, ns, torch.as_tensor(mask)),
              JP.ball_query(jnp.asarray(new), jnp.asarray(xyz), radius, ns, jnp.asarray(mask)), f"ball {radius}")
    d, i = TP.knn(*t(new, xyz), 5, torch.as_tensor(mask))
    jd, ji = JP.knn(jnp.asarray(new), jnp.asarray(xyz), 5, jnp.asarray(mask))
    exact(i, ji, "knn")
    close(d, jd, OP_RTOL, "knn d")
    d3, i3 = TP.three_nn(*t(new, xyz))
    jd3, ji3 = JP.three_nn(jnp.asarray(new), jnp.asarray(xyz))
    exact(i3, ji3, "three_nn")
    w = TP.interpolation_weights(d3)
    close(w, JP.interpolation_weights(jd3), OP_RTOL, "weights")
    feats = rnd.randn(2, 6, 200).astype(np.float32)
    close(TP.three_interpolate(torch.as_tensor(feats), i3, w),
          JP.three_interpolate(jnp.asarray(feats), ji3, JP.interpolation_weights(jd3)), OP_RTOL, "interpolate")
    idx = rnd.randint(0, 200, (2, 30)).astype(np.int32)
    close(TP.gather_points(*t(feats, idx)), JP.gather_points(jnp.asarray(feats), jnp.asarray(idx)), 0, "gather")
    for use_xyz, f in ((True, feats), (False, feats), (True, None)):
        got = TP.query_and_group(*t(xyz, new), None if f is None else torch.as_tensor(f), 0.8, 8, use_xyz,
                                 torch.as_tensor(mask))
        want = JP.query_and_group(jnp.asarray(xyz), jnp.asarray(new), None if f is None else jnp.asarray(f), 0.8, 8,
                                  use_xyz, jnp.asarray(mask))
        close(got, want, OP_RTOL, f"query_and_group {use_xyz}")


def test_stack_ops():
    rnd = np.random.RandomState(1)
    cnt = np.array([50, 30, 40])
    flat = rnd.uniform(-2, 2, (120, 3)).astype(np.float32)
    qcnt = np.array([5, 7, 4])
    q = rnd.uniform(-2, 2, (16, 3)).astype(np.float32)
    pad, m = TS.stack_to_padded(*t(flat, cnt), 64)
    jpad, jm = JS.stack_to_padded(jnp.asarray(flat), jnp.asarray(cnt), 64)
    close(pad, jpad, 0, "padded")
    exact(m, jm, "mask")
    close(TS.padded_to_stack(pad, m, 120), flat, 0, "round trip")
    exact(TS.stack_ball_query(*t(q, qcnt, flat, cnt), 0.7, 6, 64),
          JS.stack_ball_query(*map(jnp.asarray, (q, qcnt, flat, cnt)), 0.7, 6, 64), "stack ball query")
    exact(TS.stack_farthest_point_sampling(*t(flat, cnt), 8, 64),
          JS.stack_farthest_point_sampling(jnp.asarray(flat), jnp.asarray(cnt), 8, 64), "stack fps")
    d, i = TS.stack_three_nn(*t(q, qcnt, flat, cnt), 64)
    jd, ji = JS.stack_three_nn(*map(jnp.asarray, (q, qcnt, flat, cnt)), 64)
    close(d, jd, OP_RTOL, "stack three_nn d")
    exact(i, ji, "stack three_nn")


def test_voxel_query_and_vector_pool(monkeypatch):
    monkeypatch.setattr(TS, "QUERY_CHUNK", 5)  # several chunks
    rnd = np.random.RandomState(11)
    B, Z, Y, X = 2, 4, 5, 6
    coords = np.stack([rnd.randint(0, n, 60) for n in (B, Z, Y, X)], 1).astype(np.int32)
    coords[-3:] = [[0, 9, 0, 0], [1, -1, 2, 2], [0, 1, 1, 1]]  # out of the grid; a duplicate cell
    xyz = (coords[:, [3, 2, 1]] + rnd.rand(60, 3) * 0.3).astype(np.float32)
    vmask = rnd.rand(60) < 0.9
    grid = TS.voxel_indices_grid(torch.as_tensor(coords), (B, Z, Y, X), torch.as_tensor(vmask))
    jgrid = JS.voxel_indices_grid(jnp.asarray(coords), (B, Z, Y, X), jnp.asarray(vmask))
    exact(grid, jgrid, "grid")
    qmask = rnd.rand(12) < 0.8
    new_coords, new_xyz = coords[:12], xyz[:12] + 0.1
    for qr, radius, ns in (((1, 1, 1), 1.6, 4), ((2, 1, 2), 2.5, 16), ((1, 1, 1), 0.05, 4)):
        got = TS.voxel_query(*t(new_coords, new_xyz, xyz), grid, qr, radius, ns, torch.as_tensor(qmask))
        want = JS.voxel_query(*map(jnp.asarray, (new_coords, new_xyz, xyz)), jgrid, query_range=qr, radius=radius,
                              nsample=ns, new_mask=jnp.asarray(qmask))
        exact(got[0], want[0], f"voxel query {qr}")
        exact(got[1], want[1], "empty")
    sxyz = rnd.uniform(-4, 4, (50, 3)).astype(np.float32)
    sfeats = rnd.randn(50, 6).astype(np.float32)
    smask, centers, nmask = np.arange(50) < 45, rnd.uniform(-3, 3, (7, 3)).astype(np.float32), np.arange(7) < 6
    for kw in (dict(neighbor_type=0), dict(neighbor_type=1, nsample=5, use_xyz=False)):
        got = TS.vector_pool(*t(sxyz, sfeats, smask, centers, nmask), num_grid=(2, 2, 2), max_neighbour_distance=1.5,
                             num_c_each=3, chunk=4, **kw)
        want = JS.vector_pool(*map(jnp.asarray, (sxyz, sfeats, smask, centers, nmask)), num_grid=(2, 2, 2),
                              max_neighbour_distance=1.5, num_c_each=3, chunk=4, **kw)
        for g, w in zip(got, want):
            close(g, w, OP_RTOL, f"vector pool {kw}")


def test_iou_and_nms():
    rnd = np.random.RandomState(2)
    a, b = boxes(rnd, 40, 4.0), boxes(rnd, 30, 4.0)
    b[:5] = a[:5]  # identical pairs
    for fn in ("boxes_iou_bev", "boxes_iou3d", "iou_bev_axis_aligned"):
        close(getattr(TI, fn)(*t(a, b)), getattr(JI, fn)(jnp.asarray(a), jnp.asarray(b)), OP_RTOL, fn)
    close(TI.paired_boxes_iou3d(*t(a[:30], b)), JI.paired_boxes_iou3d(jnp.asarray(a[:30]), jnp.asarray(b)), OP_RTOL,
          "paired")
    scores = rnd.rand(40).astype(np.float32)
    scores[10:20] = scores[0]  # equal scores keep their index order
    mask = rnd.rand(40) < 0.85
    for normal in (False, True):
        for thresh in (0.0, 0.1, 0.5):
            order, keep = TI.nms(*t(a, scores), thresh, torch.as_tensor(mask), normal=normal)
            jorder, jkeep = JI.nms(jnp.asarray(a), jnp.asarray(scores), thresh, jnp.asarray(mask), normal=normal)
            exact(order, jorder, "order")
            exact(keep, jkeep, f"keep {thresh} {normal}")


@pytest.mark.parametrize("pool_method", ["max", "avg"])
def test_roiaware_pool3d(pool_method):
    rnd = np.random.RandomState(3)
    rois = boxes(rnd, 6, 2.0)
    pts = rnd.uniform(-3, 3, (300, 3)).astype(np.float32)
    feats = rnd.randn(300, 5).astype(np.float32)
    pmask = rnd.rand(300) < 0.9
    got = TR.roiaware_pool3d(*t(rois, pts, feats), (3, 2, 4), pool_method, torch.as_tensor(pmask))
    want = JR.roiaware_pool3d(*map(jnp.asarray, (rois, pts, feats)), (3, 2, 4), pool_method, jnp.asarray(pmask))
    close(got, want, OP_RTOL)
    assert (got != 0).any()


def test_neighbor_voxel_pool():
    rnd = np.random.RandomState(12)
    coords = np.unique(np.stack([np.zeros(60, np.int32)] + [rnd.randint(0, 5, 60) for _ in range(3)], 1), axis=0)
    xyz = coords[:, [3, 2, 1]].astype(np.float32) + 0.2
    feats = rnd.randn(len(coords), 8).astype(np.float32)
    grid = JS.voxel_indices_grid(jnp.asarray(coords), (1, 5, 5, 5))
    new_coords, new_mask = coords[:, [0, 3, 2, 1]][:9], np.arange(9) < 7
    kw = dict(query_ranges=[[1, 1, 1], [2, 2, 2]], radii=[2.0, 4.0], nsamples=[4, 8], mlps=[[8, 16, 12], [8, 16, 20]])
    for pool_method in ("max_pool", "avg_pool"):
        jm = JPool(**kw, pool_method=pool_method)
        args = (jnp.asarray(xyz), jnp.asarray(xyz[:9] + 0.05), jnp.asarray(new_coords), jnp.asarray(feats), grid,
                jnp.asarray(new_mask))
        params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 4)
        tm = load_flax_params(TPool(**kw, pool_method=pool_method), params)
        got = tm(*t(xyz, xyz[:9] + 0.05, new_coords, feats), torch.as_tensor(np.array(grid)),
                 torch.as_tensor(new_mask))
        close(got, jm.apply(params, *args), OP_RTOL, pool_method)


# ------------------------------------------------------------ the substitute detector


@pytest.fixture(scope="module")
def tiny_detector():
    rnd = np.random.RandomState(0)
    P, n = 1024, 600
    pts = np.zeros((P, 4), np.float32)
    pts[:n, :2] = rnd.uniform(-7, 7, (n, 2))
    pts[:n, 2] = rnd.uniform(-1.5, 1.5, n)
    pts[:n, 3] = rnd.rand(n)
    mask = np.arange(P) < n
    jm = JD.VoxelDetector(**TINY_DET)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask)), 5)
    tm = load_flax_params(TD.VoxelDetector(**TINY_DET), params).eval()
    return jm, tm, params, pts, mask


def test_detector_matches_jax(tiny_detector):
    jm, tm, params, pts, mask = tiny_detector
    assert tm.bev_shape == jm.bev_shape
    np.testing.assert_array_equal(tm.anchors(), jm.anchors())
    want = jax.jit(jm.apply)(params, jnp.asarray(pts), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(*t(pts, mask))
    for k in want:
        close(got[k], want[k], MODEL_RTOL, k)
    jpred = jax.jit(lambda p, m: JD.predict(jm, params, p, m, score_thresh=0.3, max_dets=16))(jnp.asarray(pts),
                                                                                              jnp.asarray(mask))
    tpred = TD.predict(tm, *t(pts, mask), score_thresh=0.3, max_dets=16)
    close(tpred[0], jpred[0], MODEL_RTOL, "boxes")
    close(tpred[1], jpred[1], MODEL_RTOL, "scores")
    exact(tpred[2].int(), jpred[2], "labels")
    exact(tpred[3], jpred[3], "keep")
    assert 0 < int(tpred[3].sum()) < 16
    anchors = np.array([[1.0, 2, -1, 4, 2, 1.5, 0.3]], np.float32)
    deltas = np.random.RandomState(1).randn(1, 7).astype(np.float32) * 0.3
    close(TD.decode_boxes(*t(deltas, anchors)), JD.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)), OP_RTOL)


# ------------------------------------------------------------ Voxel R-CNN


def flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tree(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat_tree(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def jax_tree_to_port(tree) -> dict:
    """The JAX reader's tree in the port's layouts: 2D conv kernels HWIO →
    OIHW; every other leaf as it is."""
    out = {}
    for k, v in flat_tree(tree):
        a = v if isinstance(v, (bool, int)) else np.asarray(v)
        out[k] = np.transpose(a, (3, 2, 0, 1)) if k.endswith("/kernel") and np.ndim(a) == 4 else a
    return out


def assert_same_tree(port_tree, jax_tree) -> None:
    want, got = jax_tree_to_port(jax_tree), dict(flat_tree(port_tree))
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert type(g) is type(w) if isinstance(w, (bool, int)) else g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def pcdet_sd():
    return {**_min_sparse_sd(layout="spconv2"), **_min_bev_sd(), **_min_head_sd(), **_min_roi_sd()}


@pytest.mark.parametrize("layout", ["spconv1", "spconv2"])
def test_pcdet_reader_bit_for_bit(layout):
    sd = {**_min_sparse_sd(layout=layout), **_min_bev_sd(), **_min_head_sd(), **_min_roi_sd()}
    tree = convert_voxel_rcnn({k: torch.as_tensor(v) for k, v in sd.items()})
    assert_same_tree(tree, jax_convert_voxel_rcnn(sd))
    written = to_pcdet_state_dict(tree)  # pcdet's names, spconv 2.x layout
    assert "backbone_2d.blocks.0.1.weight" in written and "roi_head.shared_fc_layer.0.weight" in written
    assert_same_tree(tree, jax_convert_voxel_rcnn({k: v.numpy() for k, v in written.items()}))
    assert_same_tree(convert_voxel_rcnn(written), jax_convert_voxel_rcnn(sd))


@pytest.fixture(scope="module")
def rcnn(pcdet_sd, tmp_path_factory):
    """Both packages' detector from one pcdet file on the reduced grid, a
    padded cloud, and the JAX ``predict`` (its ``forward`` kept)."""
    path = tmp_path_factory.mktemp("pcdet") / "voxel_rcnn.pth"
    torch.save({"model_state": {k: torch.as_tensor(v) for k, v in pcdet_sd.items()}}, path)
    jdet = JVR.load_voxel_rcnn_from_pcdet(path, **REDUCED)
    tdet = TVR.load_voxel_rcnn_from_pcdet(path, **REDUCED)
    rnd = np.random.RandomState(7)
    pts = np.concatenate([rnd.rand(2048, 2) * 14 - 7, rnd.rand(2048, 1) * 3 - 2.5, rnd.rand(2048, 1)],
                         1).astype(np.float32)
    mask = np.arange(2048) < 1900
    forward = jdet.forward
    seen = []
    jdet.forward = lambda p, m: seen.append(forward(p, m)) or seen[-1]
    want = jdet.predict(jnp.asarray(pts), jnp.asarray(mask))
    return {"path": path, "jdet": jdet, "tdet": tdet, "pts": pts, "mask": mask, "forward": seen[0],
            "predict": want}


def test_voxel_rcnn_matches_jax(rcnn):
    tdet, jdet = rcnn["tdet"], rcnn["jdet"]
    assert tdet.grid_zyx == jdet.grid_zyx == (40, 160, 160) and tdet._bev_zyx() == jdet._bev_zyx() == (1, 20, 20)
    assert tdet.class_groups == jdet.class_groups and len(tdet.class_groups) == 2
    with torch.no_grad():
        got, levels = tdet.forward(*t(rcnn["pts"], rcnn["mask"]))
    want, jlevels = rcnn["forward"]
    for (b, s, c), (jb, js, jc) in zip(got, want):
        close(b, jb, MODEL_RTOL, "proposal boxes")
        close(s, js, MODEL_RTOL, "scores")
        exact(c, jc, "classes")
    for lv, jlv in zip(levels, jlevels):
        exact(lv["coords"], jlv["coords"], "level coords")
        exact(lv["mask"], jlv["mask"], "level mask")
        close(lv["feats"], jlv["feats"], MODEL_RTOL, "level features")
    boxes_, scores, names, valid = tdet.predict(*t(rcnn["pts"], rcnn["mask"]))
    jb, js, jn, jv = rcnn["predict"]
    close(boxes_, jb, MODEL_RTOL, "refined boxes")
    close(scores, js, MODEL_RTOL, "rescored")
    assert names == jn
    exact(valid, jv, "valid")
    assert 0 < int(valid.sum()) < len(valid)


def test_voxel_rcnn_parts(rcnn):
    rnd = np.random.RandomState(9)
    rois = boxes(rnd, 5, 5.0)
    close(TVR.roi_grid_points(torch.as_tensor(rois), 4), JVR.roi_grid_points(jnp.asarray(rois), 4), OP_RTOL)
    assert TVR.level_grid_dims((41, 1440, 1440)) == JVR.level_grid_dims((41, 1440, 1440))
    coords = np.stack([rnd.randint(-1, n + 1, 50) for n in (4, 6, 7)], 1).astype(np.int32)
    mask = rnd.rand(50) < 0.9
    exact(TVR.dense_point_index_grid(*t(coords, mask), 4, 6, 7),
          JVR.dense_point_index_grid(jnp.asarray(coords), jnp.asarray(mask), 4, 6, 7))
    f = rnd.randn(50, 3).astype(np.float32)
    close(TVR.height_compression(*t(f, coords, mask), 4, 6, 7),
          JVR.height_compression(*map(jnp.asarray, (f, coords, mask)), 4, 6, 7), OP_RTOL)
    head = {"hm": rnd.randn(12, 10, 2), "center": rnd.randn(12, 10, 2), "center_z": rnd.randn(12, 10, 1),
            "dim": rnd.randn(12, 10, 3) * 0.3, "rot": rnd.randn(12, 10, 2)}
    head = {k: v.astype(np.float32) for k, v in head.items()}
    head["hm"][3, 4, 1] = head["hm"][5, 6, 0] = head["hm"].max()  # a tie: the lower index first
    pr, vs = np.array(REDUCED["point_range"], np.float32), np.array([0.1, 0.1], np.float32)
    got = TVR.decode_center_boxes({k: torch.as_tensor(v) for k, v in head.items()}, *t(pr, vs), k=16)
    want = JVR.decode_center_boxes({k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(pr), jnp.asarray(vs),
                                   k=16)
    close(got[0], want[0], OP_RTOL, "boxes")
    close(got[1], want[1], 0, "scores")
    exact(got[2], want[2], "classes")


# ------------------------------------------------------------ the metric and the CLIs


def box(x, y, dx=4.0, dy=2.0, dz=1.5, yaw=0.0):
    return [x, y, -1.0, dx, dy, dz, yaw]


def test_detection_eval_matches_jax(tmp_path):
    rnd = np.random.RandomState(10)
    names = np.array(["car", "truck", "pedestrian"])
    det, gt = [], []
    for i in range(4):
        g = boxes(rnd, 6)
        d = np.concatenate([g[:4] + rnd.randn(4, 7).astype(np.float32) * 0.2, boxes(rnd, 3)])
        det.append({"boxes_lidar": d, "score": rnd.rand(7).astype(np.float32), "name": names[rnd.randint(0, 3, 7)]})
        gt.append({"gt_boxes": np.concatenate([g, np.zeros((6, 2), np.float32)], 1), "name": names[rnd.randint(0, 3, 6)]})
    det.append({"boxes_lidar": np.asarray(box(0, 0), np.float32), "score": np.array([0.9]), "name": np.array(["car"])})
    gt.append({"gt_boxes": np.asarray(box(0.1, 0), np.float32), "name": np.array(["car"])})
    det.append({"boxes_lidar": np.zeros((0, 7), np.float32), "score": np.zeros(0), "name": np.array([])})
    gt.append({"gt_boxes": boxes(rnd, 2), "name": np.array(["car", "car"])})
    got = TDE.evaluate_detections(det, gt, list(names) + ["bus"])
    want = JDE.evaluate_detections(det, gt, list(names) + ["bus"])
    assert got == want and 0 < got["mAP"] < 1 and got["recall/rcnn_0.3"] > 0
    infos = [{"token": f"tok{i}", "gt_boxes": g["gt_boxes"], "gt_names": g["name"]} for i, g in enumerate(gt)]
    for obj in (infos, {"infos": infos}):
        with open(tmp_path / "infos.pkl", "wb") as f:
            pickle.dump(obj, f)
        mine, theirs = TDE.load_gt_infos(tmp_path / "infos.pkl"), JDE.load_gt_infos(tmp_path / "infos.pkl")
        assert list(mine) == list(theirs)
        for k in mine:
            exact(mine[k]["gt_boxes"], theirs[k]["gt_boxes"])
            exact(mine[k]["gt_names"], theirs[k]["gt_names"])
    for stem in ("sample_tok3", "tok1", "x_tok9", "tok2.ply"):
        assert TDE.match_token(stem, mine) == JDE.match_token(stem, mine)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def reduced_pcdet(monkeypatch):
    """Both packages' pcdet loader on the reduced grid (the CLIs build it
    at the nuScenes range and voxel)."""
    for mod in (JVR, TVR):
        monkeypatch.setattr(mod, "load_voxel_rcnn_from_pcdet",
                            functools.partial(mod.load_voxel_rcnn_from_pcdet,
                                              **{k: v for k, v in REDUCED.items() if k != "point_range"},
                                              point_range=REDUCED["point_range"]))


def write_clouds(rcnn, gen_dir: Path, n: int = 2) -> list:
    gen_dir.mkdir()
    clouds = []
    for i in range(n):
        c = rcnn["pts"][rcnn["mask"]].copy()
        c[:, :2] = np.roll(c[:, :2], i, axis=1) if i else c[:, :2]
        np.save(gen_dir / f"sample_tok{i}.npy", c)
        clouds.append(c)
    return clouds


def test_evaluate_detection_cli_matches_the_jax_tool(rcnn, reduced_pcdet, tiny_detector, tmp_path, monkeypatch):
    """``--pcdet-ckpt`` and ``--params``: the port's detections, AP and
    recall equal the JAX tool's on the same files; ground truth placed on
    the port's own detections so that AP is not zero.  ``--random-params``
    runs end to end."""
    write_clouds(rcnn, tmp_path / "gen")
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, tiny_detector[2]), f)
    # the JAX tool builds the default VoxelDetector: its parameters
    jd = JD.VoxelDetector()
    dflt = random_params(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((2048, 4)),
                                        jnp.ones((2048,), bool)), 6)
    # seeded at this width the class head's logits reach ~100: most scores are 1.0 in float32, and an ulp
    # between the packages reorders such ties; a narrower head keeps the scores apart
    dflt["params"]["cls_head"]["kernel"] = dflt["params"]["cls_head"]["kernel"] * 0.02
    with open(tmp_path / "default.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, dflt), f)
    with open(tmp_path / "empty.pkl", "wb") as f:
        pickle.dump([{"token": f"tok{i}", "gt_boxes": np.zeros((0, 7), np.float32), "gt_names": np.array([])}
                     for i in range(2)], f)
    common = ["--gen-dir", str(tmp_path / "gen"), "--max-points", "2048", "--score-thresh", "0.0"]
    for route in (["--pcdet-ckpt", str(rcnn["path"])], ["--params", str(tmp_path / "default.pkl")]):
        tag = route[0][2:]
        eval_det_cli.main([*common, *route, "--gt-infos", str(tmp_path / "empty.pkl"), "-o", str(tmp_path / "seed"),
                           "--device", "cpu"])
        with open(tmp_path / "seed" / "result_vxrcnn.pkl", "rb") as f:
            dets = pickle.load(f)
        infos = [{"token": d["frame_id"], "gt_boxes": d["boxes_lidar"][::2] + 0.05, "gt_names": d["name"][::2]}
                 for d in dets]
        with open(tmp_path / f"gt_{tag}.pkl", "wb") as f:
            pickle.dump(infos, f)
        args = [*common, *route, "--gt-infos", str(tmp_path / f"gt_{tag}.pkl")]
        got = eval_det_cli.main([*args, "-o", str(tmp_path / f"port_{tag}"), "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["evaluate_detection.py", *args, "-o", str(tmp_path / f"jax_{tag}")])
        _tool("evaluate_detection").main()
        want = json.loads((tmp_path / f"jax_{tag}" / "detection_eval.json").read_text())
        assert json.loads((tmp_path / f"port_{tag}" / "detection_eval.json").read_text()) == got, tag
        assert got == want, tag
        assert got["mAP"] > 0 and got["gt_num"] > 0, tag
        dets = {}
        for name in ("port", "jax"):
            with open(tmp_path / f"{name}_{tag}" / "result_vxrcnn.pkl", "rb") as f:
                dets[name] = pickle.load(f)
        for a, b in zip(dets["port"], dets["jax"]):
            assert list(a["name"]) == list(b["name"]) and a["frame_id"] == b["frame_id"]
            np.testing.assert_allclose(a["boxes_lidar"], b["boxes_lidar"], rtol=0, atol=MODEL_RTOL * 10)
            np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=MODEL_RTOL)
    res = eval_det_cli.main([*common, "--random-params", "--gt-infos", str(tmp_path / "gt_pcdet-ckpt.pkl"), "-o",
                             str(tmp_path / "random"), "--device", "cpu"])
    assert set(res) >= {"mAP", "ap", "gt_num", "recall/rcnn_0.3", "avg_pred_objects"}
    with pytest.raises(SystemExit, match="random-params"):
        eval_det_cli.main([*common, "--gt-infos", str(tmp_path / "empty.pkl"), "-o", str(tmp_path / "x"),
                           "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_det_cli.main([*common, "--random-params", "--gt-infos", str(tmp_path / "empty.pkl"), "-o",
                           str(tmp_path / "x")])


def read_objects(out: Path) -> dict:
    with open(out / "foreground_samples_info.pkl", "rb") as f:
        info = pickle.load(f)
    return {k: [(o["name"], Path(o["path"]).name, o["num_points_in_gt"], np.asarray(o["box3d_lidar"]), o["score"],
                 np.fromfile(o["path"], np.float32)) for o in v] for k, v in info.items()}


def test_extract_foreground_cli_matches_the_jax_tool(rcnn, reduced_pcdet, tiny_detector, tmp_path, monkeypatch):
    """``--pcdet-ckpt``, ``--params`` and ``--gt-infos``: the objects the
    port extracts (names, files, point counts, boxes, scores, the crops
    themselves) equal the JAX tool's.  ``--random-params`` runs end to end."""
    clouds = write_clouds(rcnn, tmp_path / "gen")
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, tiny_detector[2]), f)
    inside = [b for c in clouds for b in [box(*c[0, :2], dx=6, dy=6, dz=6), box(*c[1, :2], dx=6, dy=6, dz=6)]]
    with open(tmp_path / "gt.pkl", "wb") as f:
        pickle.dump([{"token": f"tok{i}", "gt_boxes": np.asarray(inside[2 * i:2 * i + 2], np.float32),
                      "gt_names": np.array(["car", "pedestrian"])} for i in range(2)], f)
    rng = ["--point-range", *map(str, REDUCED["point_range"])]
    common = ["--gen-dir", str(tmp_path / "gen"), "--max-points", "2048", "--min-points", "5"]
    routes = {"pcdet": ["--pcdet-ckpt", str(rcnn["path"]), "--score-thresh", "0.0", *rng],
              "params": ["--params", str(tmp_path / "params.pkl"), "--voxel-size", "0.5", "--score-thresh", "0.0",
                         "--point-range", "-8", "-8", "-2", "8", "8", "2"],
              "gt": ["--gt-infos", str(tmp_path / "gt.pkl"), "--keep-classes", "car", "pedestrian"]}
    for tag, route in routes.items():
        fg_cli.main([*common, *route, "-o", str(tmp_path / f"port_{tag}"), "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["extract_foreground.py", *common, *route, "-o", str(tmp_path / f"jax_{tag}")])
        _tool("extract_foreground").main()
        got, want = read_objects(tmp_path / f"port_{tag}"), read_objects(tmp_path / f"jax_{tag}")
        assert sum(map(len, got.values())) > 0, tag
        assert {k: [o[:3] for o in v] for k, v in got.items()} == {k: [o[:3] for o in v] for k, v in want.items()}
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a[3], b[3], rtol=0, atol=MODEL_RTOL * 10, err_msg=tag)
                np.testing.assert_allclose(a[4], b[4], rtol=0, atol=MODEL_RTOL, err_msg=tag)
                np.testing.assert_allclose(a[5], b[5], rtol=0, atol=MODEL_RTOL * 10, err_msg=tag)
    fg_cli.main([*common, "--random-params", "--voxel-size", "0.5", "-o", str(tmp_path / "random"), "--device", "cpu",
                 "--point-range", "-8", "-8", "-2", "8", "8", "2"])
    assert (tmp_path / "random" / "result.pkl").exists()
