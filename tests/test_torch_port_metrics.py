"""The metric suite's tensor functions in the PyTorch port against the JAX
package, on the CPU, on numpy-seeded inputs.

Limits: the BEV histograms and occupancy grids exactly (points on bin and
range edges included); chamfer distances 1e-6 with equal argmin indices,
with and without masks; the auction EMD at 256 points with an equal
assignment and distances 1e-6; the Fréchet distance 1e-4 relative against
the JAX package at 16 dims (float32 there), 1e-6 against
``scipy.linalg.sqrtm`` in float64, and 1e-6 against the JAX package in
float64 where the covariances are rank-deficient; the squared MMD on the
same subsets 1e-5; JSD / RBF-MMD of histograms 1e-6; ICP's (R, t) 1e-4
against the JAX package and 1e-3 against the known transform; TCD and TTCE
1e-6; the calibration chain exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from torch_port_harness import one_torch_thread  # noqa: F401 (autouse)

from lidarcrafter_tpu.metrics import bev as JBM
from lidarcrafter_tpu.metrics import distribution as JD
from lidarcrafter_tpu.metrics import temporal as JTm
from lidarcrafter_tpu.ops import bev as JB
from lidarcrafter_tpu.ops import chamfer as JC
from lidarcrafter_tpu.ops import emd as JE
from lidarcrafter_tpu_torch.metrics import bev as TBM
from lidarcrafter_tpu_torch.metrics import distribution as TD
from lidarcrafter_tpu_torch.metrics import temporal as TTm
from lidarcrafter_tpu_torch.ops import bev as TB
from lidarcrafter_tpu_torch.ops import chamfer as TC
from lidarcrafter_tpu_torch.ops import emd as TE


def edge_cloud(rnd, n, half, step):
    """Points spread past ±half, a share of them exactly on bin edges
    (multiples of ``step``) and on ±half."""
    pts = (rnd.rand(n, 3).astype(np.float32) - 0.5) * 2.4 * half
    k = n // 4
    pts[:k, :2] = step * rnd.randint(-int(half / step), int(half / step) + 1, (k, 2))
    pts[k : k + 8, 0] = half
    pts[k + 8 : k + 16, 1] = -half
    pts[k + 16 : k + 24, :2] = half
    return pts


@pytest.mark.parametrize("masked", [False, True])
def test_point_cloud_to_histogram_matches_jax_exactly(masked):
    rnd = np.random.RandomState(0)
    pts = edge_cloud(rnd, 4000, 80.0, 1.6)
    pts[-20:] = [[3.0, 0.0, 0.0]] * 10 + [[0.0, 70.0, 0.0]] * 10  # depth on min / max edges
    mask = rnd.rand(len(pts)) > 0.2 if masked else None
    want = JB.point_cloud_to_histogram(jnp.asarray(pts), None if mask is None else jnp.asarray(mask))
    got = TB.point_cloud_to_histogram(torch.tensor(pts), None if mask is None else torch.tensor(mask))
    assert got.shape == (100, 100) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) > 500


@pytest.mark.parametrize("data_type,masked", [("32", False), ("32", True), ("64", False)])
def test_bev_occupancy_grid_matches_jax_exactly(data_type, masked):
    rnd = np.random.RandomState(1)
    half = 30.0 if data_type == "32" else 50.0
    pts = edge_cloud(rnd, 3000, half, 0.5)
    mask = rnd.rand(len(pts)) > 0.3 if masked else None
    want = JBM.bev_occupancy_grid(jnp.asarray(pts), None if mask is None else jnp.asarray(mask), data_type=data_type)
    got = TBM.bev_occupancy_grid(torch.tensor(pts), None if mask is None else torch.tensor(mask), data_type=data_type)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.sum()) < len(pts)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("masks", ["none", "x", "y", "both"])
def test_chamfer_distance_matches_jax(dims, masks):
    rnd = np.random.RandomState(2)
    x = rnd.rand(2, 300, dims).astype(np.float32)
    y = rnd.rand(2, 517, dims).astype(np.float32)
    y[:, :40] = x[:, :40]  # exact matches: zero distances
    xm = rnd.rand(2, 300) > 0.3 if masks in ("x", "both") else None
    ym = rnd.rand(2, 517) > 0.3 if masks in ("y", "both") else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.tensor(a)

    want = JC.chamfer_distance(j(x), j(y), j(xm), j(ym), chunk=128)
    got = TC.chamfer_distance(t(x), t(y), t(xm), t(ym), chunk=128)
    for name, g, w in zip(("dist1", "dist2"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=name)
    for name, g, w in zip(("idx1", "idx2"), got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(float(TC.chamfer_metric(t(x), t(y), t(xm), t(ym))),
                               float(JC.chamfer_metric(j(x), j(y), j(xm), j(ym))), rtol=1e-6)


@pytest.mark.parametrize("iters", [50, 5])
def test_emd_auction_matches_jax(iters):
    """50 iterations (the default) and 5, where the auction stops early and
    the last-iteration assignment leaves targets taken twice."""
    rnd = np.random.RandomState(3)
    a = rnd.rand(2, 256, 3).astype(np.float32)
    b = rnd.rand(2, 256, 3).astype(np.float32)
    jd, ja = JE.emd_auction(jnp.asarray(a), jnp.asarray(b), iters=iters, chunk=96)
    td, ta = TE.emd_auction(torch.tensor(a), torch.tensor(b), iters=iters, chunk=96)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    if iters == 5:
        assert all(len(set(row)) < 256 for row in ta.numpy())
    np.testing.assert_allclose(float(TE.emd_metric(torch.tensor(a), torch.tensor(b), iters=iters)),
                               float(JE.emd_metric(jnp.asarray(a), jnp.asarray(b), iters=iters)), rtol=1e-6)


def test_emd_needs_equal_shapes():
    with pytest.raises(ValueError):
        TE.emd_auction(torch.zeros(1, 8, 3), torch.zeros(1, 9, 3))


def _frechet_f64(f1, f2):
    f1, f2 = f1.astype(np.float64), f2.astype(np.float64)
    s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2).real
    return float(((f1.mean(0) - f2.mean(0)) ** 2).sum() + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def test_frechet_distance_matches_jax_and_scipy():
    rnd = np.random.RandomState(4)
    f1 = rnd.randn(200, 16).astype(np.float32)
    f2 = (rnd.randn(180, 16) * 1.3 + 0.2).astype(np.float32)
    got = TD.compute_frechet_distance(f1, f2, device="cpu")
    np.testing.assert_allclose(got, JD.compute_frechet_distance(f1, f2), rtol=1e-4)
    np.testing.assert_allclose(got, _frechet_f64(f1, f2), rtol=1e-6)
    assert abs(TD.compute_frechet_distance(f1, f1, device="cpu")) < 1e-9


def test_frechet_distance_rank_deficient_matches_jax_in_float64():
    """64 dims from 10 and 12 samples: the eigenvalue clip decides the
    result; the port computes in float64, as the JAX package does with x64."""
    rnd = np.random.RandomState(5)
    f1 = rnd.randn(10, 64).astype(np.float32)
    f2 = rnd.randn(12, 64).astype(np.float32)
    with jax.enable_x64():
        want = JD.compute_frechet_distance(f1, f2)
    np.testing.assert_allclose(TD.compute_frechet_distance(f1, f2, device="cpu"), want, rtol=1e-6)


def test_squared_mmd_matches_jax_on_the_same_subsets():
    rnd = np.random.RandomState(6)
    f1 = rnd.randn(200, 16).astype(np.float32)
    f2 = (rnd.randn(150, 16) * 1.2).astype(np.float32)
    for kw in ({"num_subsets": 10, "max_subset_size": 50, "seed": 3}, {"num_subsets": 4}):
        np.testing.assert_allclose(TD.compute_squared_mmd(f1, f2, device="cpu", **kw),
                                   JD.compute_squared_mmd(f1, f2, **kw), rtol=1e-5)


def test_jsd_and_mmd_of_histograms_match_jax():
    rnd = np.random.RandomState(7)
    h1 = rnd.poisson(3.0, (6, 20, 20)).astype(np.float32)
    h2 = rnd.poisson(2.0, (5, 20, 20)).astype(np.float32)
    h2[:, :3] = 0  # empty bins on one side
    np.testing.assert_allclose(TBM.compute_jsd_2d(torch.tensor(h1), torch.tensor(h2)),
                               JBM.compute_jsd_2d(jnp.asarray(h1), jnp.asarray(h2)), rtol=1e-6)
    np.testing.assert_allclose(TBM.compute_mmd_2d(torch.tensor(h1), torch.tensor(h2)),
                               JBM.compute_mmd_2d(jnp.asarray(h1), jnp.asarray(h2)), rtol=1e-5, atol=1e-7)
    clouds = [edge_cloud(rnd, 500, 30.0, 0.5) for _ in range(4)]
    np.testing.assert_allclose(TBM.compute_jsd_bev(clouds[:2], clouds[2:], device="cpu"),
                               JBM.compute_jsd_bev(clouds[:2], clouds[2:]), rtol=1e-6)


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def test_icp_matches_jax_and_recovers_a_known_transform():
    rnd = np.random.RandomState(8)
    src = rnd.uniform(-10, 10, (700, 3)).astype(np.float32)
    R_true, t_true = _rot_z(0.05), np.array([0.5, -0.3, 0.1], np.float32)
    tgt = src @ R_true.T + t_true
    src_mask = rnd.rand(700) > 0.1
    for kw_j, kw_t in (({}, {}), ({"src_mask": jnp.asarray(src_mask)}, {"src_mask": torch.tensor(src_mask)})):
        Rj, tj = JTm.icp_point_to_point(jnp.asarray(src), jnp.asarray(tgt), **kw_j)
        Rt, tt = TTm.icp_point_to_point(torch.tensor(src), torch.tensor(tgt), **kw_t)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(Rt.numpy(), R_true, atol=1e-3)
        np.testing.assert_allclose(tt.numpy(), t_true, atol=1e-3)


def _infos(n, rnd):
    def quat(yaw):
        return [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]

    return [{"lidar2ego_rotation": quat(0.01), "lidar2ego_translation": [0.9, 0.0, 1.8],
             "ego2global_rotation": quat(0.02 * i), "ego2global_translation": [100.0 + 1.5 * i, 50.0 + 0.2 * i, 0.0]}
            for i in range(n)]


def test_relative_gt_transform_is_the_jax_packages():
    infos = _infos(3, None)
    for a, b in ((0, 0), (0, 2), (2, 1)):
        for got, want in zip(TTm.relative_gt_transform(infos[a], infos[b]),
                             JTm.relative_gt_transform(infos[a], infos[b])):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sequence():
    """Six frames of one scene moved by a rigid motion each, with a little
    noise and differing point counts."""
    rnd = np.random.RandomState(9)
    base = rnd.uniform(-15, 15, (600, 3)).astype(np.float32)
    frames = []
    for i in range(6):
        f = base @ _rot_z(0.01 * i).T + np.array([0.3 * i, 0.05 * i, 0.0], np.float32)
        frames.append((f + 0.01 * rnd.randn(*f.shape)).astype(np.float32)[: 600 - 20 * i])
    return frames


def test_sequence_tcd_matches_jax(sequence):
    want = JTm.sequence_tcd(sequence)
    got = TTm.sequence_tcd(sequence, device="cpu")
    assert list(got) == [1, 2, 3, 4] and [len(v) for v in got.values()] == [5, 4, 3, 2]
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-6)
    assert np.mean(got[4]) > np.mean(got[1])


def test_sequence_ttce_matches_jax(sequence):
    infos = _infos(len(sequence), None)
    want = JTm.sequence_ttce(sequence, infos)
    got = TTm.sequence_ttce(sequence, infos, device="cpu")
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5, atol=1e-6)
