"""The sparse 3D stack of the PyTorch port against the JAX package, on the
CPU: the voxel table ops (``ops/sparse.py``), MinkowskiNet and SPVCNN
(``metrics/extractor/sparse_unet.py``) through the weight bridge and
through upstream's torchsparse state dicts, the eval descriptor, the kNN
label clean-up, and the FSVD / FPVD backbones of a pretrained root behind
``EvaluationEngine``.

Limits: voxel coordinates, masks, slots, source points and inverses bit for
bit; the upstream readers bit for bit; the ops 1e-5 of the largest output;
whole backbones and descriptors 1e-4 of the largest; kNN labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.metrics.engine import EvaluationEngine as JaxEngine
from lidarcrafter_tpu.metrics.extractor import knn_postproc as JK
from lidarcrafter_tpu.metrics.extractor import sparse_unet as JU
from lidarcrafter_tpu.ops import sparse as JS
from lidarcrafter_tpu_torch.metrics.engine import EvaluationEngine
from lidarcrafter_tpu_torch.metrics.extractor import knn_postproc as TK
from lidarcrafter_tpu_torch.metrics.extractor import sparse_unet as TU
from lidarcrafter_tpu_torch.metrics.pretrained import load_sparse_backbone, load_sparse_descriptor
from lidarcrafter_tpu_torch.ops import sparse as TS
from lidarcrafter_tpu_torch.weights import load_flax_params

OP_RTOL, MODEL_RTOL = 1e-5, 1e-4
TINY = dict(layer_num=(8, 8, 12, 8, 16, 8, 8, 12, 8), cr=1.0, input_dims=4, num_classes=5, voxel_size=0.5,
            max_voxels=256)


def close(got: torch.Tensor, want, rtol: float, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def exact(got: torch.Tensor, want, what: str = "") -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def cloud(n_valid=300, n_pad=400, seed=0, span=(-6.0, 6.0)):
    rnd = np.random.RandomState(seed)
    pts = np.zeros((n_pad, 3), np.float32)
    pts[:n_valid] = rnd.uniform(*span, (n_valid, 3))
    feats = np.zeros((n_pad, 4), np.float32)
    feats[:n_valid] = rnd.randn(n_valid, 4)
    return pts, feats, np.arange(n_pad) < n_valid


@pytest.fixture(scope="module")
def table():
    """A voxel table of 512 rows from a padded cloud at 0.7 m, and seeded
    features and kernels."""
    pts, feats, mask = cloud()
    coords, _, vmask, _ = JS.voxelize(jnp.asarray(pts), 0.7, jnp.asarray(mask), max_voxels=512)
    rnd = np.random.RandomState(1)
    return {"coords": np.asarray(coords), "mask": np.asarray(vmask), "f": rnd.randn(512, 5).astype(np.float32),
            "k27": rnd.randn(27, 5, 6).astype(np.float32), "k8": rnd.randn(8, 5, 6).astype(np.float32),
            "up": rnd.randn(512, 6).astype(np.float32), "k8up": rnd.randn(8, 6, 5).astype(np.float32),
            "pts": pts, "feats": feats, "pmask": mask}


def t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("max_voxels", [512, 64])  # 64: more voxels than the budget
@pytest.mark.parametrize("voxel_size", [0.7, 0.05])
def test_voxelize_is_exact(max_voxels, voxel_size):
    pts, _, mask = cloud(seed=2, span=(-40.0, 40.0))
    want = JS.voxelize(jnp.asarray(pts), voxel_size, jnp.asarray(mask), max_voxels=max_voxels)
    got = TS.voxelize(*t(pts), voxel_size, torch.as_tensor(mask), max_voxels=max_voxels)
    for name, g, w in zip(("coords", "source point", "mask", "inverse"), got, want):
        exact(g, w, name)
    assert got[2].sum() == min(max_voxels, len(np.unique(np.floor(pts[mask] / np.float32(voxel_size)), axis=0)))


def test_keys_keep_the_pair_order():
    """The int64 key orders as the JAX (hi, lo) pair does, the ±1-cell
    offsets of the taps included, and a lookup is its lower bound."""
    rnd = np.random.RandomState(3)
    c = np.concatenate([rnd.randint(-2, 3, (300, 3)), rnd.randint(-(1 << 15), (1 << 15) - 1, (300, 3)),
                        [[0, 32767, -32768], [0, -32768, 32767], [5, 0, 0], [5, -1, 32767]]]).astype(np.int32)
    hi, lo = JS.coords_key(jnp.asarray(c))
    want = np.lexsort((np.asarray(lo), np.asarray(hi)))
    key = TS.coords_key(torch.as_tensor(c))
    exact(torch.sort(key, stable=True).indices, want)
    mask = rnd.rand(len(c)) < 0.7
    shi, slo, sidx = JS._sorted_key_table(jnp.asarray(c), jnp.asarray(mask))
    q = np.concatenate([c, c + 1]).astype(np.int32)
    qhi, qlo = JS.coords_key(jnp.asarray(q))
    want = JS._neighbor_lookup(shi, slo, sidx, qhi, qlo)
    got = TS.lookup(TS.sorted_key_table(*t(c, mask)), TS.coords_key(torch.as_tensor(q)),
                    torch.ones(len(q), dtype=torch.bool))
    exact(got.int(), want)


def test_submanifold_conv(table):
    want = JS.submanifold_conv3d(*map(jnp.asarray, (table["f"], table["coords"], table["mask"], table["k27"])))
    close(TS.submanifold_conv3d(*t(table["f"], table["coords"], table["mask"], table["k27"])), want, OP_RTOL)


def test_downsample_and_upsample(table):
    want = JS.sparse_downsample2(*map(jnp.asarray, (table["f"], table["coords"], table["mask"], table["k8"])),
                                 max_voxels=512)
    got = TS.sparse_downsample2(*t(table["f"], table["coords"], table["mask"], table["k8"]), max_voxels=512)
    close(got[0], want[0], OP_RTOL, "features")
    exact(got[1], want[1], "coords")
    exact(got[2], want[2], "mask")
    want_up = JS.sparse_upsample2(jnp.asarray(table["up"]), want[1], want[2], jnp.asarray(table["coords"]),
                                  jnp.asarray(table["mask"]), jnp.asarray(table["k8up"]))
    got_up = TS.sparse_upsample2(torch.as_tensor(table["up"]), got[1], got[2], *t(table["coords"], table["mask"],
                                                                                  table["k8up"]))
    close(got_up, want_up, OP_RTOL)


@pytest.mark.parametrize("geometry", [dict(out_spatial=None), dict(out_spatial=(40, 40, 40)),
                                      dict(kernel_size=(3, 1, 1), stride=(2, 1, 1), padding=(0, 0, 0),
                                           out_spatial=(24, 40, 40))])
def test_strided_conv(table, geometry):
    taps = int(np.prod(geometry.get("kernel_size", (3, 3, 3))))
    k = np.random.RandomState(4).randn(taps, 5, 6).astype(np.float32)
    want = JS.sparse_conv3d_strided(*map(jnp.asarray, (table["f"], table["coords"], table["mask"], k)),
                                    max_voxels=256, **geometry)
    got = TS.sparse_conv3d_strided(*t(table["f"], table["coords"], table["mask"], k), max_voxels=256, **geometry)
    close(got[0], want[0], OP_RTOL, "features")
    exact(got[1], want[1], "coords")
    exact(got[2], want[2], "mask")


def test_point_voxel_interop(table):
    pts, feats, pmask = table["pts"], table["feats"], table["pmask"]
    want = JS.voxelize_mean(jnp.asarray(pts), jnp.asarray(feats), 0.7, jnp.asarray(pmask), max_voxels=512)
    got = TS.voxelize_mean(*t(pts, feats), 0.7, torch.as_tensor(pmask), max_voxels=512)
    close(got[0], want[0], OP_RTOL, "voxel means")
    for name, g, w in zip(("coords", "mask", "stride-1 coords", "inverse"), got[1:], want[1:]):
        exact(g, w, name)
    vf = np.random.RandomState(5).randn(512, 3).astype(np.float32)
    for level in (0, 1, 2):
        w = JS.point_to_voxel_mean(jnp.asarray(feats), want[3], jnp.asarray(pmask), want[1], want[2], level=level)
        close(TS.point_to_voxel_mean(torch.as_tensor(feats), got[3], torch.as_tensor(pmask), got[1], got[2],
                                     level=level), w, OP_RTOL, f"point_to_voxel_mean level {level}")
        w = JS.voxel_to_point_trilinear(jnp.asarray(vf), want[1], want[2], want[3], jnp.asarray(pmask), level=level)
        close(TS.voxel_to_point_trilinear(torch.as_tensor(vf), got[1], got[2], got[3], torch.as_tensor(pmask),
                                          level=level), w, OP_RTOL, f"trilinear level {level}")


def test_voxelize_coords_mean():
    rnd = np.random.RandomState(6)
    ci = rnd.randint(0, 20, (400, 3)).astype(np.int32)
    feats = rnd.randn(400, 4).astype(np.float32)
    mask = rnd.rand(400) < 0.8
    for mv in (1024, 100):
        want = JS.voxelize_coords_mean(*map(jnp.asarray, (ci, feats, mask)), max_voxels=mv)
        got = TS.voxelize_coords_mean(*t(ci, feats, mask), max_voxels=mv)
        close(got[0], want[0], OP_RTOL, "means")
        exact(got[1], want[1], "coords")
        exact(got[2], want[2], "mask")


# ------------------------------------------------------------ the backbones


@pytest.fixture(scope="module")
def backbones():
    """Each backbone in both packages with one weight tree, and the JAX
    forward (jitted once) on a padded cloud."""
    pts, feats, mask = cloud(n_valid=300, n_pad=400, seed=7, span=(0.0, 12.0))
    out = {}
    for name in ("MinkowskiNet", "SPVCNN"):
        jm, tm = getattr(JU, name)(**TINY), getattr(TU, name)(**TINY)
        params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *map(jnp.asarray, (pts, feats, mask))),
                               3)
        load_flax_params(tm, params)
        want = jax.jit(jm.apply)(params, *map(jnp.asarray, (pts, feats, mask)))
        out[name] = (jm, tm.eval(), params, {k: np.asarray(v) for k, v in want.items()})
    return out, (pts, feats, mask)


@pytest.mark.parametrize("name", ["MinkowskiNet", "SPVCNN"])
def test_backbone_matches_jax(backbones, name):
    models, inputs = backbones
    _, tm, _, want = models[name]
    with torch.no_grad():
        got = tm(*t(*inputs))
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype.kind in "biu":
            exact(got[k], w, k)
        else:
            close(got[k], w, MODEL_RTOL, k)
    assert np.abs(want["logits"]).max() > 0.1  # not a vacuous comparison


@pytest.mark.parametrize("name", ["MinkowskiNet", "SPVCNN"])
def test_torchsparse_readers_bit_for_bit(backbones, name):
    """Upstream's state dict written from the port's weights reads back
    through the JAX converter and the port's to the same tensors."""
    models, _ = backbones
    jm, tm, _, _ = models[name]
    sd = TU.to_torchsparse_state_dict(tm.state_dict())
    assert "stem.0.weight" in sd and "stage2.1.downsample.0.weight" in sd
    assert ("point_transforms.0.0.weight" in sd) == (name == "SPVCNN")
    theirs = getattr(TU, name)(**TINY)
    load_flax_params(theirs, JU.convert_torchsparse_state_dict({k: v.numpy() for k, v in sd.items()}))
    ours = TU.convert_torchsparse_state_dict(sd)
    assert set(ours) == set(theirs.state_dict()) == set(tm.state_dict())
    for k, v in theirs.state_dict().items():
        assert torch.equal(ours[k], v) and torch.equal(tm.state_dict()[k], v), k


def test_tap_order():
    """torchsparse's odd kernels enumerate x fastest, even ones z fastest."""
    np.testing.assert_array_equal(TU._tap_perm(3), JU._tap_perm(3))
    np.testing.assert_array_equal(TU._tap_perm(2), np.arange(8))
    assert TU._tap_perm(3)[1] == 9  # our (0, 0, 1) is torchsparse's (x=0, y=0, z=1) = 1·9


@pytest.mark.parametrize("agg_type", ["depth", "sector", "all"])
def test_aggregate_sectors(backbones, agg_type):
    models, _ = backbones
    want = models["MinkowskiNet"][3]
    kw = dict(agg_type=agg_type, depth_range=(1.0, 5.0), voxel_size=0.5)
    w = JU.aggregate_sectors(*map(jnp.asarray, (want["logits"], want["coords"], want["mask"])), **kw)
    close(TU.aggregate_sectors(*t(want["logits"], want["coords"], want["mask"]), **kw), w, OP_RTOL)


def test_knn_postprocess():
    for s, sig in ((5, 1.0), (7, 2.0), (3, 0.8)):
        np.testing.assert_array_equal(TK.inv_gaussian_window(s, sig), JK.inv_gaussian_window(s, sig))
    H, W, P, ncls = 16, 64, 500, 9
    rnd = np.random.RandomState(0)
    proj_range = (rnd.rand(H, W) * 50).astype(np.float32)
    proj_range[rnd.rand(H, W) < 0.1] = -1.0
    proj_argmax = rnd.randint(0, ncls, (H, W)).astype(np.int32)
    px, py = rnd.randint(0, W, P).astype(np.int32), rnd.randint(0, H, P).astype(np.int32)
    unproj = (rnd.rand(P) * 50).astype(np.float32)
    for cutoff in (1.0, 0.0):
        want = JK.knn_postprocess(*map(jnp.asarray, (proj_range, unproj, proj_argmax, px, py)), knn=5, search=5,
                                  sigma=1.0, cutoff=cutoff, nclasses=ncls)
        got = TK.knn_postprocess(*t(proj_range, unproj, proj_argmax, px, py), knn=5, search=5, sigma=1.0,
                                 cutoff=cutoff, nclasses=ncls)
        exact(got, want, f"cutoff {cutoff}")


# ------------------------------------------------------------ the eval path


@pytest.fixture(scope="module")
def sparse_root(tmp_path_factory, backbones):
    """``{root}/nuscenes/{minkowskinet,spvcnn}/model.ckpt`` of the seeded
    backbones, upstream-format, the JAX package's way under
    ``'state_dict'``."""
    models, _ = backbones
    root = tmp_path_factory.mktemp("sparse_root")
    for name, folder in (("MinkowskiNet", "minkowskinet"), ("SPVCNN", "spvcnn")):
        (root / "nuscenes" / folder).mkdir(parents=True)
        torch.save({"state_dict": TU.to_torchsparse_state_dict(models[name][1].state_dict())},
                   root / "nuscenes" / folder / "model.ckpt")
    return root


def scan(rnd, n=500):
    r, az, el = rnd.uniform(3, 40, n), rnd.uniform(-np.pi, np.pi, n), rnd.uniform(-0.5, 0.15, n)
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1).astype(np.float32)


def test_engine_with_sparse_backbones(sparse_root):
    """``EvaluationEngine`` with the root's backbones behind
    ``voxel_apply`` / ``point_voxel_apply`` against the JAX engine with the
    JAX descriptors of the same checkpoints."""
    from lidarcrafter_tpu.metrics import eval_suite as JES

    rnd = np.random.RandomState(8)
    real, gen = [scan(rnd) for _ in range(3)], [scan(rnd) for _ in range(3)]
    P = 256
    engine = EvaluationEngine(voxel_apply=load_sparse_descriptor(sparse_root, "minkowskinet", max_points=P,
                                                                 device="cpu"),
                              point_voxel_apply=load_sparse_descriptor(sparse_root, "spvcnn", max_points=P,
                                                                       device="cpu"),
                              max_points_sparse=P, device="cpu")
    jfns = {}
    for name in ("minkowskinet", "spvcnn"):
        model, params = JES._load_sparse_backbone(name, sparse_root / "nuscenes" / name, P)
        jfns[name] = JU.make_sparse_descriptor_fn(model, params, depth_range=(1.0, 45.0))
    jengine = JaxEngine(voxel_apply=jfns["minkowskinet"], point_voxel_apply=jfns["spvcnn"], max_points_sparse=P)
    got = {tag: engine.extract_features(c, tag) for tag, c in (("real", real), ("gen", gen))}
    want = {tag: jengine.extract_features(c, tag) for tag, c in (("real", real), ("gen", gen))}
    for tag in got:
        for k in ("voxel", "point_voxel"):
            assert got[tag][k].shape == (3, 16 * 8)
            close(torch.as_tensor(got[tag][k]), want[tag][k], MODEL_RTOL, f"{tag} {k}")
    assert np.abs(want["real"]["voxel"]).max() > 0.01
    res = engine.evaluate(real, gen, ["fsvd", "fpvd"])
    assert set(res) == {"fsvd", "fsvd_mmd", "fpvd", "fpvd_mmd"} and all(np.isfinite(v) for v in res.values())
    assert load_sparse_descriptor(sparse_root, "spvcnn", dataset="kitti", device="cpu") is None
    model = load_sparse_backbone(sparse_root / "nuscenes" / "spvcnn", "spvcnn", P, "cpu")
    assert isinstance(model, TU.SPVCNN) and model.cs == [8, 8, 12, 8, 16, 8, 8, 12, 8]
