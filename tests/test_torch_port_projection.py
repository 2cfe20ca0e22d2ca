"""The rollout geometry of the PyTorch port against the JAX package on the
same numpy-seeded inputs: the point rotation, box membership, the range
projection and box rasterisation, the trajectory helpers and warps, and
the rollout's point ops.

Integer and bool outputs (pixel ids, winner indices, membership, masks,
the split's gathered indices) must match exactly; float outputs to 1e-5 of
max(1, max |JAX|).  Projected points are drawn at random pixel centres, up
to 0.4 of a pixel away, and member points away from box faces, so that no
point lies on a bin edge or a face, where an ulp of ``arcsin`` / ``arctan2``
between XLA and torch could move it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarcrafter_tpu.datasets import rollout as JR
from lidarcrafter_tpu.datasets.transforms import rotate_points_along_z_jnp
from lidarcrafter_tpu.ops import points as JP
from lidarcrafter_tpu.ops import projection as JX
from lidarcrafter_tpu_torch.datasets import rollout as TR
from lidarcrafter_tpu_torch.datasets.transforms import rotate_points_along_z
from lidarcrafter_tpu_torch.ops import projection as TX
from lidarcrafter_tpu_torch.ops.points import points_in_boxes

RTOL = 1e-5
H, W = 32, 1024
FOV_UP, FOV_DOWN = math.radians(10.0), math.radians(-30.0)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(1.0, float(np.abs(want).max())))


def assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def t(a):
    return torch.as_tensor(np.array(a))


def pixel_points(rnd, n, H=H, W=W, depth=(2.0, 70.0), feats=1, rows=None, cols=None):
    """(n, 3+feats) f32 points at random pixel centres (of the first
    ``rows`` / ``cols`` only, if given), at most 0.4 px off in each
    direction, at random depths."""
    h = rnd.randint(0, rows or H, n) + 0.5 + rnd.uniform(-0.4, 0.4, n)
    w = rnd.randint(0, cols or W, n) + 0.5 + rnd.uniform(-0.4, 0.4, n)
    elevation = (1.0 - h / H) * (FOV_UP - FOV_DOWN) - abs(FOV_DOWN)
    azimuth = (2.0 * w / W - 1.0) * np.pi  # grid_w = (azimuth/π + 1)/2
    r = rnd.uniform(*depth, n)
    horiz = r * np.cos(elevation)
    xyz = np.stack([horiz * np.cos(-azimuth), horiz * np.sin(-azimuth), r * np.sin(elevation)], 1)
    return np.concatenate([xyz, rnd.uniform(0, 200, (n, feats))], 1).astype(np.float32)


def random_boxes(rnd, k, spread=25.0):
    """(k, 7) boxes [x, y, z, dx, dy, dz, yaw]."""
    return np.concatenate([
        rnd.uniform(-spread, spread, (k, 2)), rnd.uniform(-1, 1, (k, 1)),
        rnd.uniform(1.0, 5.0, (k, 3)), rnd.uniform(-np.pi, np.pi, (k, 1)),
    ], 1).astype(np.float32)


def points_near_boxes(rnd, boxes, n_per_box, n_far):
    """Points inside each box (local coords within 0.45 of the size) and
    just outside (0.55-0.8), plus far points: none within 5% of a face."""
    pts = []
    for b in boxes:
        u = rnd.uniform(-0.8, 0.8, (n_per_box, 3))
        u = np.where(np.abs(u) < 0.5, np.clip(u, -0.45, 0.45), np.sign(u) * np.maximum(np.abs(u), 0.55))
        local = u * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        world = np.stack([local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c, local[:, 2]], 1)
        pts.append(world + b[:3])
    pts.append(np.concatenate([rnd.uniform(-60, 60, (n_far, 2)), rnd.uniform(-3, 3, (n_far, 1))], 1) + 200.0)
    xyz = np.concatenate(pts).astype(np.float32)
    return np.concatenate([xyz, rnd.uniform(0, 200, (len(xyz), 1)).astype(np.float32)], 1)


# ------------------------------------------------------------------ module 1


def test_rotate_points_along_z_matches_jax():
    rnd = np.random.RandomState(0)
    pts = rnd.standard_normal((3, 50, 5)).astype(np.float32) * 20
    ang = rnd.uniform(-np.pi, np.pi, 3).astype(np.float32)
    assert_close(rotate_points_along_z(t(pts), t(ang)), rotate_points_along_z_jnp(jnp.asarray(pts), jnp.asarray(ang)))


# ------------------------------------------------------------------ module 2


@pytest.mark.parametrize("batched", [False, True])
def test_points_in_boxes_matches_jax(batched):
    rnd = np.random.RandomState(1)
    boxes = random_boxes(rnd, 6)
    pts = points_near_boxes(rnd, boxes, 200, 100)[:, :3]
    if batched:
        boxes = np.stack([boxes, random_boxes(rnd, 6)])
        pts = np.stack([pts, points_near_boxes(rnd, boxes[1], 200, 100)[:1300, :3]])
    want = np.asarray(JP.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = points_in_boxes(t(pts), t(boxes)).numpy()
    assert_equal(got, want)
    assert 0 < got.sum() < got.size


def test_points_in_boxes_margin_and_z_edges():
    """x/y within 1e-5 of the half size count (margin), z exactly at the
    half height counts (``<=``), just past it does not."""
    boxes = np.array([[0, 0, 0, 2, 4, 2, 0]], np.float32)
    pts = np.array([[0.999995, 0, 0], [0, 2.000005, 0], [0, 0, 1.0], [0, 0, 1.001], [1.01, 0, 0]], np.float32)
    want = np.asarray(JP.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = points_in_boxes(t(pts), t(boxes)).numpy()
    assert_equal(got, want)
    assert_equal(got[0], [True, True, True, False, False])


# ------------------------------------------------------------------ module 3


def test_spherical_grid_coords_matches_jax():
    pts = pixel_points(np.random.RandomState(2), 5000)
    jh, jw, jd = JX.spherical_grid_coords(jnp.asarray(pts[:, :3]), H, W)
    th, tw, td = TX.spherical_grid_coords(t(pts[:, :3]), H, W)
    assert_equal(th, jh)
    assert_equal(tw, jw)
    assert_close(td, jd)


def _jax_winners(pts, mask):
    """Lines 75-104 of the JAX ``points_to_range_image``: the winner index
    and hit of each pixel."""
    N = pts.shape[0]
    gh, gw, depth = JX.spherical_grid_coords(jnp.asarray(pts[:, :3]), H, W)
    pixel = jnp.where(jnp.asarray(mask), gh * W + gw, H * W)
    idx = jnp.arange(N, dtype=jnp.int32)
    pix_s, _, idx_s = jax.lax.sort((pixel, depth, idx), num_keys=2, is_stable=True)
    run_start = jnp.concatenate([jnp.array([True]), pix_s[1:] != pix_s[:-1]])
    scatter_ix = jnp.where(run_start & (pix_s < H * W), pix_s, H * W + idx)
    winner = jnp.full((H * W,), N, jnp.int32).at[scatter_ix].set(idx_s, mode="drop", unique_indices=True)
    hit = winner < N
    return np.asarray(jnp.clip(winner, 0, N - 1)), np.asarray(hit), np.asarray(pixel)


def _projection_case(case):
    rnd = np.random.RandomState(3)
    if case == "sparse":
        pts = pixel_points(rnd, 4000)
    else:  # several points a pixel, depth ties, padding
        base = pixel_points(rnd, 3000, rows=8, cols=64)  # ~6 points a pixel
        dup = base[rnd.randint(0, 3000, 600)].copy()
        dup[:, 3] = rnd.uniform(0, 200, 600)  # same xyz (a depth tie), other features
        pts = np.concatenate([base, dup, pixel_points(rnd, 400)])
    mask = np.ones(len(pts), bool)
    if case == "padded":
        mask[rnd.rand(len(pts)) < 0.3] = False
        pts[~mask] = rnd.uniform(-5, 5, (int((~mask).sum()), 4))  # padding anywhere, even near the origin
    return pts, mask


@pytest.mark.parametrize("case", ["sparse", "ties", "padded"])
def test_points_to_range_image_matches_jax(case):
    pts, mask = _projection_case(case)
    want = np.asarray(JX.points_to_range_image(jnp.asarray(pts), jnp.asarray(mask), H=H, W=W))
    got = TX.points_to_range_image(t(pts), t(mask), H=H, W=W).numpy()
    assert got.shape == (H, W, 6)
    assert_close(got, want)
    jw, jhit, jpix = _jax_winners(pts, mask)
    gh, gw, depth = TX.spherical_grid_coords(t(pts[:, :3]), H, W)
    pixel = torch.where(t(mask), gh.long() * W + gw, H * W)
    assert_equal(pixel, jpix)
    winner, hit = TX.range_image_winners(pixel[None], depth[None], H * W)
    assert_equal(hit[0], jhit)
    assert_equal(winner[0], jw)


def test_depth_ties_go_to_the_lowest_index():
    p = pixel_points(np.random.RandomState(4), 1)
    pts = np.concatenate([p, p, p]) * np.array([[1, 1, 1, 0]], np.float32) + np.array([[0, 0, 0, 1], [0, 0, 0, 2], [0, 0, 0, 3]], np.float32)
    mask = np.array([False, True, True])  # the padded index 0 never wins
    img = TX.points_to_range_image(t(pts), t(mask), H=H, W=W).numpy()
    want = np.asarray(JX.points_to_range_image(jnp.asarray(pts), jnp.asarray(mask), H=H, W=W))
    assert_close(img, want)
    hit = img[..., 3] > 0
    assert hit.sum() == 1 and img[..., 3][hit][0] == 2.0


def test_points_to_range_image_batched_matches_per_scene():
    rnd = np.random.RandomState(5)
    pts = np.stack([pixel_points(rnd, 3000) for _ in range(2)])
    mask = rnd.rand(2, 3000) > 0.1
    both = TX.points_to_range_image(t(pts), t(mask), H=H, W=W).numpy()
    for s in range(2):
        assert_equal(both[s], TX.points_to_range_image(t(pts[s]), t(mask[s]), H=H, W=W).numpy())
        assert_close(both[s], JX.points_to_range_image(jnp.asarray(pts[s]), jnp.asarray(mask[s]), H=H, W=W))


def test_convert_points_to_2d_and_box_corners_match_jax():
    rnd = np.random.RandomState(6)
    pts = pixel_points(rnd, 3000)
    assert_close(TX.convert_points_to_2d(t(pts)), JX.convert_points_to_2d(jnp.asarray(pts)))
    boxes = random_boxes(rnd, 13)
    assert_close(TX.box_corners_3d(t(boxes)), JX.box_corners_3d(jnp.asarray(boxes)))


def _boxes_case(case):
    rnd = np.random.RandomState(7)
    boxes = np.concatenate([random_boxes(rnd, 13), rnd.randint(0, 9, (13, 1))], 1).astype(np.float32)
    mask = np.ones(13, bool)
    if case == "seam":  # boxes behind the ego, across the azimuth seam
        boxes[:3, :3] = [[-12.0, 0.3, 0.0], [-20.0, -0.5, 0.5], [-6.0, 0.0, -0.5]]
    if case == "overlap":  # nested and shifted copies: the later box wins
        boxes[5] = boxes[4] * np.array([1, 1, 1, 0.5, 0.5, 1, 1, 1], np.float32)
        boxes[5, 7] = (boxes[4, 7] + 1) % 9
        boxes[6] = boxes[4] + np.array([0.5, 0.5, 0, 0, 0, 0, 0, 0], np.float32)
        boxes[6, 7] = (boxes[4, 7] + 2) % 9
    if case == "masked":
        mask[[1, 4, 12]] = False
    return boxes, mask


@pytest.mark.parametrize("case", ["random", "seam", "overlap", "masked"])
def test_convert_boxes_to_2d_matches_jax(case):
    boxes, mask = _boxes_case(case)
    want = JX.convert_boxes_to_2d(jnp.asarray(boxes), jnp.asarray(mask), H=H, W=W)
    got = TX.convert_boxes_to_2d(t(boxes), t(mask), H=H, W=W)
    for g, w in zip(got, want):
        assert_close(g, w)
    cm = got[1].numpy()
    assert (cm[..., 0] > 0).any()
    if case == "seam":  # a wrapped box covers both ends of a row
        x1, x2 = np.asarray(want[0])[0, [0, 2]]
        assert (x2 - x1) > 0.6
        assert (cm[..., 1] > 0)[:, 0].any() and (cm[..., 1] > 0)[:, -1].any()
    if case == "overlap":  # the later boxes' classes show over box 4's
        assert set(np.unique(cm[..., 0])) >= {boxes[5, 7], boxes[6, 7]}


def test_convert_boxes_to_2d_batched_matches_per_scene():
    b0, m0 = _boxes_case("seam")
    b1, m1 = _boxes_case("masked")
    both = TX.convert_boxes_to_2d(t(np.stack([b0, b1])), t(np.stack([m0, m1])), H=H, W=W)
    for s, (b, m) in enumerate([(b0, m0), (b1, m1)]):
        one = TX.convert_boxes_to_2d(t(b), t(m), H=H, W=W)
        for g, w in zip(both, one):
            assert_equal(g[s], w)


# ------------------------------------------------------------------ module 4


def _trajs(seed, K=4, still=False):
    rnd = np.random.RandomState(seed)
    trajs = (rnd.rand(K + 1, 6, 2) * 0.5).astype(np.float32)
    if still:  # object 1 stands still from step 2 on, object 2 throughout
        trajs[2, 2:] = 0.0
        trajs[3] = 0.0
    return trajs


@pytest.mark.parametrize("M", [None, 16, 9])
def test_trajectory_helpers_match_jax(M):
    trajs = _trajs(8)
    ego_j, obj_j = JR.expand_future_trajs(trajs, M=M)
    ego_t, obj_t = TR.expand_future_trajs(trajs, M=M)
    assert_equal(ego_t, ego_j)
    assert_equal(obj_t, obj_j)
    assert_equal(TR.interp_trajs(trajs, 11), JR.interp_trajs(trajs, 11))
    assert_equal(TR.compute_inter_frame_transforms(ego_t), JR.compute_inter_frame_transforms(ego_j))
    assert_close(TR.ego_yaws(t(ego_t)), JR.ego_yaws(jnp.asarray(ego_j)))


def test_warp_lidar_future_matches_jax():
    rnd = np.random.RandomState(9)
    P = (rnd.standard_normal((500, 4)) * 20).astype(np.float32)
    ego, _ = JR.expand_future_trajs(_trajs(9), M=16)
    assert_close(TR.warp_lidar_future(t(P), t(ego)), JR.warp_lidar_future(jnp.asarray(P), jnp.asarray(ego)))


@pytest.mark.parametrize("still", [False, True])
def test_warp_boxes_future_matches_jax(still):
    trajs = _trajs(10, still=still)
    boxes0 = random_boxes(np.random.RandomState(10), 4)
    ego, obj = JR.expand_future_trajs(trajs, M=16)
    want = np.asarray(JR.warp_boxes_future(jnp.asarray(boxes0), jnp.asarray(obj), jnp.asarray(ego)))
    got = TR.warp_boxes_future(t(boxes0), t(obj), t(ego)).numpy()
    assert_close(got, want)
    if still:
        # a standing object keeps its last heading (relative to the ego):
        # box 2 boxes0's throughout, box 1 its last moving step's once it
        # stops (knot 2 of 6 is step 5 of the 16-point resampling)
        yaw_ego = np.asarray(JR.ego_yaws(jnp.asarray(ego)))
        np.testing.assert_allclose(got[2, :, 6] + yaw_ego, boxes0[2, 6], atol=1e-5)
        heading = got[1, :, 6] + yaw_ego
        np.testing.assert_allclose(heading[5:], heading[4], atol=1e-5)
        assert abs(heading[4] - boxes0[1, 6]) > 1e-2
    # batched over scenes as the rollout calls it
    both = TR.warp_boxes_future(t(np.stack([boxes0] * 2)), t(np.stack([obj] * 2)), t(np.stack([ego] * 2)))
    assert_equal(both[1], got)


# ------------------------------------------------------------------ module 5


def _split_inputs(seed, N_extra=0):
    rnd = np.random.RandomState(seed)
    boxes = random_boxes(rnd, 4)
    boxes[1] = boxes[0] + np.array([0.3, 0.2, 0, 0, 0, 0, 0.1], np.float32)  # overlapping
    pts = points_near_boxes(rnd, boxes, 150, 200 + N_extra)
    mask = rnd.rand(len(pts)) > 0.1
    box_mask = np.array([True, True, True, False])
    return pts, mask, boxes, box_mask


def _jax_split(pts, mask, boxes, box_mask, P):
    return [np.asarray(a) for a in JR.split_foreground_background(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(boxes), jnp.asarray(box_mask), max_points_per_obj=P
    )]


@pytest.mark.parametrize("P", [64, 2048])  # 2048 > N: the zero-padded N < P branch
def test_split_foreground_background_matches_jax(P):
    pts, mask, boxes, box_mask = _split_inputs(11)
    want = _jax_split(pts, mask, boxes, box_mask, P)
    got = TR.split_foreground_background(t(pts[None]), t(mask[None]), t(boxes[None]), t(box_mask[None]), P)
    got = [g[0].numpy() for g in got]
    assert_equal(got[0], want[0])  # background mask
    assert_equal(got[2], want[2])  # object point masks
    assert_close(got[1], want[1])
    assert got[2][:3].sum(1).min() > 0 and got[2][3].sum() == 0
    # the gathered indices: the first P members in point order, then the rest
    member = np.asarray(JP.points_in_boxes(jnp.asarray(pts[:, :3]), jnp.asarray(boxes))) & mask & box_mask[:, None]
    N = len(pts)
    take = min(P, N)
    want_src = np.asarray(jnp.argsort(jnp.where(jnp.asarray(member), jnp.arange(N), N), axis=-1)[:, :take])
    assert_equal(TR.first_member_indices(t(member), take), want_src)


def test_split_batched_matches_one_scene_at_a_time():
    a, b = _split_inputs(12), _split_inputs(13)
    n = min(len(a[0]), len(b[0]))
    scenes = [[x[:n] if i < 2 else x for i, x in enumerate(s)] for s in (a, b)]
    both = TR.split_foreground_background(*(t(np.stack(z)) for z in zip(*scenes)), 128)
    for s, scene in enumerate(scenes):
        one = TR.split_foreground_background(*(t(x[None]) for x in scene), 128)
        for g, w in zip(both, one):
            assert_equal(g[s], w[0])
        want = _jax_split(*scene, 128)
        assert_equal(both[0][s], want[0])
        assert_close(both[1][s], want[1])


def test_replay_transform_and_delete_match_jax():
    rnd = np.random.RandomState(14)
    pts, mask, boxes, box_mask = _split_inputs(14)
    obj = (rnd.standard_normal((4, 32, 4)) * 2).astype(np.float32)
    obj_mask = rnd.rand(4, 32) > 0.2
    want = JR.replay_objects(jnp.asarray(obj), jnp.asarray(obj_mask), jnp.asarray(boxes), jnp.asarray(box_mask))
    got = TR.replay_objects(t(obj[None]), t(obj_mask[None]), t(boxes[None]), t(box_mask[None]))
    assert_close(got[0][0], want[0])
    assert_equal(got[1][0], want[1])

    ego, _ = JR.expand_future_trajs(_trajs(14), M=16)
    T = JR.compute_inter_frame_transforms(ego)[3]
    want = JR.transform_points_homogeneous(jnp.asarray(pts), jnp.asarray(T, jnp.float32))
    got = TR.transform_points_homogeneous(t(pts[None]), t(T[None].astype(np.float32)))
    assert_close(got[0], want)

    want = JR.delete_fg_points_mask(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(boxes), jnp.asarray(box_mask))
    got = TR.delete_fg_points_mask(t(pts[None]), t(mask[None]), t(boxes[None]), t(box_mask[None]))
    assert_equal(got[0], want)


@pytest.mark.parametrize("res", [(32, 1024), (32, 128)])
def test_refine_points_via_condition_mask_matches_jax(res):
    h, w = res
    rnd = np.random.RandomState(15)
    pts = pixel_points(rnd, 6000, H=h, W=w)
    mask = rnd.rand(6000) > 0.05
    boxes = np.concatenate([random_boxes(rnd, 6, spread=15), rnd.randint(1, 9, (6, 1))], 1).astype(np.float32)
    box_mask = np.array([True] * 5 + [False])
    want = JR.refine_points_via_condition_mask(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(boxes), jnp.asarray(box_mask), H=h, W=w
    )
    got = TR.refine_points_via_condition_mask(t(pts[None]), t(mask[None]), t(boxes[None]), t(box_mask[None]), H=h, W=w)
    assert_close(got[0][0], want[0])
    assert_equal(got[1][0], want[1])
    assert 0 < int(got[1].sum()) < h * w
