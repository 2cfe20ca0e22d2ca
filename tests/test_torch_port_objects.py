"""The object-level metrics of the PyTorch port against the JAX package, on
the CPU: the object-uncertainty crops and their KFold split, the box codec,
the binning and CGF / DCF dictionaries, PointMLP (64 points, embed 8, two
stages, k = 8), GLENet (latent 3), flax-rule BatchNorm, RGF's pass records
and fold dictionary with the JAX draws injected, the upstream GLENet reader
and the native segmenter.

Limits: crops, splits, bins, CGF / DCF dictionaries, the codec round trip
and the converter exactly; forward passes 1e-5 of the largest output; the
running statistics after 3 train-mode forwards 1e-4; RGF records and the
final dictionary 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.datasets import object_uncertainty as JOU
from lidarcrafter_tpu.metrics import fg_object as JFG
from lidarcrafter_tpu.metrics.extractor import pointmlp as JPM
from lidarcrafter_tpu.metrics.extractor import sparse_unet as JSU
from lidarcrafter_tpu.metrics.models import glenet as JGL
from lidarcrafter_tpu.metrics.models import ptv3 as JPT
from lidarcrafter_tpu.utils.torch_ckpt import convert_glenet as jax_convert_glenet
from lidarcrafter_tpu_torch.datasets import object_uncertainty as TOU
from lidarcrafter_tpu_torch.metrics import fg_object as TFG
from lidarcrafter_tpu_torch.metrics.extractor import pointmlp as TPM
from lidarcrafter_tpu_torch.metrics.extractor import sparse_unet as TSU
from lidarcrafter_tpu_torch.metrics.models import glenet as TGL
from lidarcrafter_tpu_torch.metrics.models import ptv3 as TPT
from lidarcrafter_tpu_torch.models.batch_norm import BatchNorm
from lidarcrafter_tpu_torch.utils.torch_ckpt import convert_glenet, to_glenet_state_dict
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, init_random_, load_flax_params

FWD_RTOL, STATS_RTOL, RGF_RTOL = 1e-5, 1e-4, 1e-5
SMALL_MLP = dict(points=64, embed_dim=8, dim_expansion=(2, 2), pre_blocks=(1, 2), pos_blocks=(2, 1),
                 k_neighbors=(8, 8), reducers=(2, 2))
LATENT = 3
TEXT_FEAT = {c: np.random.RandomState(3).randn(1, 512).astype(np.float32) for c in JOU.CLASS_NAMES}


def close(got, want, rtol: float, what: str = "") -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()), err_msg=what)


def make_infos(n, seed=0, num_pts=64):
    """Crop records with in-memory points; every fourth a pedestrian, which
    RGF drops."""
    rng = np.random.RandomState(seed)
    names = ["car", "truck", "bus", "pedestrian"]
    return [
        {
            "name": names[i % 4],
            "num_points_in_gt": int(rng.randint(10, 500)),
            "box3d_lidar": np.array([*(rng.randn(3) * 2), 4.2, 1.9, 1.7, rng.uniform(-3, 3)], np.float32),
            "points": (rng.randn(num_pts, 4) * 0.8).astype(np.float32),
        }
        for i in range(n)
    ]


# ------------------------------------------------------------ the crops


def test_kfold_and_flatten_match_jax_exactly():
    for n in (7, 23, 100):
        for a, b in zip(TOU.kfold_val_indices(n), JOU.kfold_val_indices(n), strict=True):
            np.testing.assert_array_equal(a, b)
    infos = make_infos(12)
    by_class = {"car": infos[:3], "pedestrian": infos[3:5], "bus": infos[5:]}
    for src in (infos, by_class):
        assert TOU.flatten_uncertainty_infos(src) == JOU.flatten_uncertainty_infos(src)


def test_box_codec_round_trip_matches_jax_exactly():
    rng = np.random.RandomState(1)
    for _ in range(5):
        box = np.array([*rng.randn(3), *rng.uniform(0.5, 5, 3), rng.uniform(-3, 3)], np.float32)
        args = (box, *rng.randn(3), tuple(rng.randn(2)), float(rng.randn()), float(rng.uniform(0.9, 1.1)), True)
        np.testing.assert_array_equal(TOU.encode_gt_box(*args), JOU.encode_gt_box(*args))
    boxes = rng.randn(6, 9).astype(np.float32)
    np.testing.assert_array_equal(TOU.decode_boxes(boxes), JOU.decode_boxes(boxes))
    # decode(encode(box)) gives the box's size back, centred at its points' mean
    enc = TOU.encode_gt_box(np.array([0, 0, 0, 4.0, 1.8, 1.5, 0.3], np.float32), 0.0, 0.0, 0.0)
    np.testing.assert_allclose(TOU.decode_boxes(enc[None])[0], [0, 0, 0, 4.0, 1.8, 1.5, 0.3], atol=1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_dataset_items_match_jax_bit_for_bit(training, tmp_path):
    infos = make_infos(30)
    # half the crops from .bin files, as extract_foreground writes them
    for i, info in enumerate(infos[::2]):
        path = tmp_path / f"{i}.bin"
        info.pop("points").tofile(path)
        info["path"] = str(path)
    t = TOU.ObjectUncertaintyDataset(infos, 3, TEXT_FEAT, training=training, rng=np.random.RandomState(5))
    j = JOU.ObjectUncertaintyDataset(infos, 3, TEXT_FEAT, training=training, rng=np.random.RandomState(5))
    assert len(t) == len(j) > 0
    for bt, bj in zip(t.batches(4), j.batches(4), strict=True):
        assert bt.keys() == bj.keys()
        for k in bt:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)


# ---------------------------------------------------- binning, CGF and DCF


def test_bins_classification_and_dcf_match_jax_exactly():
    rng = np.random.RandomState(2)
    counts = np.concatenate([[0, 100, 100.5, 200, 500, 501], rng.randint(0, 900, 50)])
    for bins, labels in ((JFG.CGF_BINS, JFG.CGF_LABELS), (JFG.RGF_BINS, JFG.RGF_LABELS)):
        np.testing.assert_array_equal(TFG._bin_labels(counts, bins, labels), JFG._bin_labels(counts, bins, labels))
    res = {"class_names": ["car", "truck", "bus", "pedestrian"], "test_true": rng.randint(0, 4, 56),
           "test_pred": rng.randint(0, 4, 56), "num_points_in_gt": counts}
    assert TFG.compute_classification_metrics_fixed_bins(res) == JFG.compute_classification_metrics_fixed_bins(res)
    recs = {str(i): {"variance": rng.rand(7).tolist(), "overlap": float(rng.rand()), "pointnum": int(c)}
            for i, c in enumerate(counts)}
    assert TFG.compute_rgf(recs) == JFG.compute_rgf(recs)
    dets = {c: [{"name": c, "score": float(s)} for s in rng.rand(5)] for c in ("car", "bus", "pedestrian", "barrier")}
    assert TFG.compute_dcf(dets) == JFG.compute_dcf(dets)
    assert "barrier" not in TFG.compute_dcf(dets)


# ----------------------------------------------------------------- PointMLP


@pytest.fixture(scope="module")
def pointmlp():
    """The small PointMLP in both packages with one weight tree (dropout 0,
    so the train-mode forward draws nothing), and a batch of clouds."""
    jm = JPM.point_mlp(4, dropout=0.0, **SMALL_MLP)
    tm = TPM.point_mlp(4, dropout=0.0, **SMALL_MLP)
    x = np.random.RandomState(4).randn(6, 64, 3).astype(np.float32)
    variables = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x[:1])), 11)
    load_flax_params(tm, variables)
    return jm, tm, variables, x


def test_pointmlp_forward_matches_jax(pointmlp):
    jm, tm, variables, x = pointmlp
    tm.eval()
    with torch.no_grad():
        for kw in ({}, {"return_features": True}):
            want = np.asarray(jax.jit(lambda v, a, kw=kw: jm.apply(v, a, **kw))(variables, jnp.asarray(x)))
            got = tm(torch.as_tensor(x), **kw)
            close(got, want, FWD_RTOL, str(kw))
            assert np.abs(want).max() > 0.1


def test_pointmlp_grouper_matches_jax(pointmlp):
    """FPS indices and kNN groups exactly, the affine groups to 1e-5."""
    _, _, _, x = pointmlp
    jg = JPM.LocalGrouper(8, 16, 8)
    tg = TPM.LocalGrouper(8, 16, 8)
    feats = np.random.RandomState(6).randn(*x.shape[:2], 8).astype(np.float32)
    params = random_params(jax.eval_shape(jg.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feats)), 2)
    load_flax_params(tg, params)
    want_xyz, want = jg.apply(params, jnp.asarray(x), jnp.asarray(feats))
    got_xyz, got = tg(torch.as_tensor(x), torch.as_tensor(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    close(got, want, FWD_RTOL)


def test_pointmlp_train_forward_statistics_match_jax(pointmlp):
    """Three train-mode forwards: logits 1e-5 each time, then every
    BatchNorm's running mean and variance (flax's rule) 1e-4."""
    jm, _, variables, x = pointmlp
    tm = TPM.point_mlp(4, dropout=0.0, **SMALL_MLP)
    load_flax_params(tm, variables)
    fwd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))
    for i in range(3):
        xi = x + 0.1 * i
        want, mutated = fwd(variables, jnp.asarray(xi))
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            close(tm(torch.as_tensor(xi), train=True), want, FWD_RTOL, f"forward {i}")
    expected = flax_to_state_dict(variables, tm)
    got = tm.state_dict()
    stats = [k for k in expected if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        close(got[k], expected[k].numpy(), STATS_RTOL, k)


def test_batch_norm_follows_flax():
    """Momentum 0.99 on the old average and the biased batch variance, not
    ``torch.nn.BatchNorm1d``'s rule."""
    rng = np.random.RandomState(8)
    jbn = fnn.BatchNorm(use_running_average=False)
    xs = [(rng.randn(5, 7, 6) * 3 + 1).astype(np.float32) for _ in range(3)]
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    variables = {"params": {"scale": 1 + 0.1 * rng.randn(6).astype(np.float32),
                            "bias": 0.1 * rng.randn(6).astype(np.float32)},
                 "batch_stats": variables["batch_stats"]}
    tbn = BatchNorm(6)
    load_flax_params(tbn, variables)
    for x in xs:
        want, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **mutated}
        close(tbn(torch.as_tensor(x), train=True), want, FWD_RTOL)
    close(tbn.running_mean, variables["batch_stats"]["mean"], STATS_RTOL)
    close(tbn.running_var, variables["batch_stats"]["var"], STATS_RTOL)
    eval_want = fnn.BatchNorm(use_running_average=True).apply(variables, jnp.asarray(xs[0]))
    close(tbn(torch.as_tensor(xs[0])), eval_want, FWD_RTOL)
    torch_bn = torch.nn.BatchNorm1d(6, momentum=0.01)
    for x in xs:
        torch_bn(torch.as_tensor(x).reshape(-1, 6))
    assert not torch.allclose(torch_bn.running_var, tbn.running_var, atol=1e-5)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = TPM.dropout(x, 0.5, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    y3 = TPM.dropout(x, 0.3, g)
    assert abs(float((y3 != 0).float().mean()) - 0.7) < 0.01
    assert torch.allclose(y3[y3 != 0], torch.full_like(y3[y3 != 0], 1 / 0.7))
    assert TPM.dropout(x, 0.0, g) is x
    m = TPM.point_mlp(4, **SMALL_MLP)  # dropout 0.5 in train mode only
    pts = torch.randn(2, 64, 3)
    with torch.no_grad():
        a, b = m(pts, train=True, generator=torch.Generator().manual_seed(1)), m(pts, train=True,
                                                                             generator=torch.Generator().manual_seed(2))
        assert not torch.equal(a, b)
        assert torch.equal(m(pts), m(pts))


def test_cgf_matches_jax_exactly(pointmlp):
    jm, tm, variables, _ = pointmlp
    rng = np.random.RandomState(9)
    clouds = [rng.randn(64, 4).astype(np.float32) for _ in range(20)]
    labels = rng.randint(0, 4, 20)
    npts = rng.randint(0, 700, 20)
    names = ("car", "truck", "bus", "pedestrian")
    want = JFG.compute_cgf(jax.jit(lambda a: jm.apply(variables, a)), clouds, labels, npts, names, batch_size=8)
    got = TFG.compute_cgf(TFG.pointmlp_logits(tm), clouds, labels, npts, names, batch_size=8, device="cpu")
    assert got == want
    assert len(got["partitions"]) > 2


# ------------------------------------------------------------------- GLENet


def glenet_batch(B=5, N=64, seed=0):
    rng = np.random.RandomState(seed)
    return {"points": rng.randn(B, N, 3).astype(np.float32), "text_feat": rng.randn(B, 512).astype(np.float32),
            "gt_boxes_input": rng.randn(B, 8).astype(np.float32), "gt_boxes": rng.randn(B, 7).astype(np.float32)}


@pytest.fixture(scope="module")
def glenet():
    kw = dict(TGL.EXP20_KWARGS, latent_size=LATENT)
    jm, tm = JGL.GLENet(**kw), TGL.GLENet(**kw)
    batch = glenet_batch()
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, {k: jnp.asarray(v) for k, v in
                                                                               batch.items()},
                                          rng=jax.random.PRNGKey(1), train=True))
    variables = random_params(shapes, 12)
    load_flax_params(tm, variables)
    return jm, tm.eval(), variables, batch


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_glenet_eval_matches_jax(glenet):
    jm, tm, variables, batch = glenet
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(rng, (len(batch["points"]), LATENT)))
    with torch.no_grad():
        close(tm(tbatch(batch), eps=torch.as_tensor(eps)), jm.apply(variables, jb, rng=rng), FWD_RTOL, "drawn")
        close(tm(tbatch(batch)), jm.apply(variables, jb), FWD_RTOL, "prior mean")


def test_glenet_train_branch_matches_jax(glenet):
    """Losses and boxes of the train branch with the JAX draw injected; the
    running statistics after 3 forwards 1e-4."""
    jm, _, variables, batch = glenet
    tm = TGL.GLENet(**dict(TGL.EXP20_KWARGS, latent_size=LATENT))
    load_flax_params(tm, variables)
    fwd = jax.jit(lambda v, b, r: jm.apply(v, b, rng=r, train=True, mutable=["batch_stats"]))
    for i in range(3):
        b = {k: v + 0.05 * i for k, v in batch.items()}
        rng = jax.random.PRNGKey(20 + i)
        (reg, latent, box), mutated = fwd(variables, {k: jnp.asarray(v) for k, v in b.items()}, rng)
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        eps = torch.as_tensor(np.array(jax.random.normal(rng, (len(b["points"]), LATENT))))
        with torch.no_grad():
            treg, tlat, tbox = tm(tbatch(b), eps=eps, train=True)
        close(treg, reg, FWD_RTOL, "reg")
        close(tlat, latent, FWD_RTOL, "latent")
        close(tbox, box, FWD_RTOL, "box")
    expected = flax_to_state_dict(variables, tm)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            close(v, expected[k].numpy(), STATS_RTOL, k)


def test_glenet_loss_helpers_match_jax():
    rng = np.random.RandomState(13)
    a, b, c, d = (rng.randn(6, 4).astype(np.float32) for _ in range(4))
    close(TGL.kl_diag_gaussians(*map(torch.as_tensor, (a, b, c, d))), JGL.kl_diag_gaussians(a, b, c, d), FWD_RTOL)
    b1, b2 = rng.randn(6, 9).astype(np.float32), rng.randn(6, 7).astype(np.float32) * 4
    for got, want in zip(TGL.add_sin_difference(torch.as_tensor(b1), torch.as_tensor(b2)),
                         JGL.add_sin_difference(b1, b2)):
        close(got, want, FWD_RTOL)
    np.testing.assert_array_equal(TGL.get_direction_target(torch.as_tensor(b2), 0.78539, 2).numpy(),
                                  np.asarray(JGL.get_direction_target(b2, 0.78539, 2)))
    diff = np.linspace(-1, 1, 101).astype(np.float32)
    close(TGL.smooth_l1(torch.as_tensor(diff)), JGL.smooth_l1(diff), FWD_RTOL)
    params = [rng.randn(3, 4).astype(np.float32), np.zeros(5, np.float32)]
    close(TGL.l2_param_norm([torch.as_tensor(p) for p in params]), JGL.l2_param_norm(params), FWD_RTOL)


def test_mc_uncertainty_matches_jax(glenet):
    jm, tm, variables, batch = glenet
    rng = jax.random.PRNGKey(4)
    var, mean = JGL.mc_uncertainty(lambda bd, r: jm.apply(variables, bd, rng=r),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, rng, num_passes=4)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(rng, i), (len(batch["points"]), LATENT)))
             for i in range(4)]
    tvar, tmean = TGL.mc_uncertainty(lambda bd, e: tm(bd, eps=e), tbatch(batch),
                                     lambda i: torch.as_tensor(draws[i]), num_passes=4)
    close(tvar, var, FWD_RTOL)
    close(tmean, mean, FWD_RTOL)


def test_convert_glenet_matches_jax_bit_for_bit(tmp_path):
    """A synthetic upstream state dict (seeded port weights written under
    upstream's names) read by both converters; the file read by both
    loaders gives one model."""
    model = init_random_(TGL.GLENet(latent_size=LATENT), 21)
    sd = to_glenet_state_dict(model.state_dict())
    assert "x_encoder.fe.output_sequential.2.weight" in sd and sd["x_encoder.fe.conv1.weight"].ndim == 3
    got, want = convert_glenet(sd), jax_convert_glenet({k: v.numpy() for k, v in sd.items()})
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert np.asarray(flat_got[k]).dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(np.asarray(flat_got[k]), np.asarray(v), err_msg=str(k))
    torch.save({"model_state": {**sd, "x_encoder.fe.bn1.num_batches_tracked": torch.tensor(3)}},
               tmp_path / "glenet.pth")
    tm = TGL.load_glenet_from_torch(tmp_path / "glenet.pth", latent_size=LATENT)
    jm, jvars = JGL.load_glenet_from_torch(tmp_path / "glenet.pth", latent_size=LATENT)
    batch = glenet_batch(seed=2)
    with torch.no_grad():
        close(tm(tbatch(batch)), jm.apply(jvars, {k: jnp.asarray(v) for k, v in batch.items()}), FWD_RTOL)
        for k, v in model.state_dict().items():
            assert torch.equal(tm.state_dict()[k], v), k


# ---------------------------------------------------------------------- RGF


def jax_draw(fold, pass_idx, batch, shape, device):
    """The JAX package's draw of RGF's (fold, pass, batch) from PRNGKey(7)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), fold), pass_idx), batch)
    return torch.as_tensor(np.asarray(jax.random.normal(key, shape)), device=device)


def test_rgf_pass_records_and_folds_match_jax(glenet):
    """Two folds × three passes over 40 crops (30 of them car / truck /
    bus), batch 4: one pass's records to 1e-5, then the fold dictionary."""
    jm, tm, variables, _ = glenet
    infos = make_infos(40, seed=5)
    japply = jax.jit(lambda bd, rng: jm.apply(variables, bd, rng=rng))
    used = JOU.flatten_uncertainty_infos(infos)
    ds = {pkg: mod.ObjectUncertaintyDataset(used, 0, TEXT_FEAT, training=False,
                                            rng=np.random.RandomState(1000))
          for pkg, mod in (("jax", JOU), ("torch", TOU))}
    rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 0), 0)
    want = JFG.glenet_pass_records(japply, ds["jax"], rng, batch_size=4)
    got = TFG.glenet_pass_records(TFG.glenet_apply(tm), ds["torch"], lambda bi, n: jax_draw(0, 0, bi, (n, LATENT),
                                                                                            "cpu"),
                                  batch_size=4, device="cpu")
    assert got.keys() == want.keys() and len(got) == 3
    for key, rec in want.items():
        close(got[key]["pred_box"], rec["pred_box"], RGF_RTOL, key)
        assert got[key]["gt_box"] == rec["gt_box"]
        close(got[key]["overlap"], rec["overlap"], RGF_RTOL, key)

    want = JFG.compute_rgf_folds(infos, lambda f: japply, jax.random.PRNGKey(7), num_passes=3, num_folds=2,
                                 batch_size=4, text_feat=TEXT_FEAT)
    got = TFG.compute_rgf_folds(infos, lambda f: TFG.glenet_apply(tm), jax_draw, num_passes=3, num_folds=2,
                                batch_size=4, text_feat=TEXT_FEAT, latent_size=LATENT, device="cpu")
    assert got.keys() == want.keys() and got["partitions"].keys() == want["partitions"].keys()
    for part in ("overall", *(("partitions", p) for p in want["partitions"])):
        g = got[part] if isinstance(part, str) else got[part[0]][part[1]]
        w = want[part] if isinstance(part, str) else want[part[0]][part[1]]
        close(g["variance"], w["variance"], RGF_RTOL, str(part))
        close(g["overlap"], w["overlap"], RGF_RTOL, str(part))
    assert max(want["overall"]["variance"]) > 1e-6  # the passes drew different boxes


def test_seeded_draws_repeat_per_fold_and_pass():
    draw = TFG.seeded_draws(7)
    a = [draw(1, 2, b, (3, 4), "cpu") for b in range(2)]
    c = [draw(1, 3, b, (3, 4), "cpu") for b in range(2)]
    again = [draw(1, 2, b, (3, 4), "cpu") for b in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


# -------------------------------------------------------------- segmenter


def test_segment_cloud_matches_jax():
    tiny = dict(layer_num=(8, 8, 12, 8, 16, 8, 8, 12, 8), cr=1.0, input_dims=4, num_classes=17, voxel_size=0.5,
                max_voxels=256)
    jm, tm = JSU.MinkowskiNet(**tiny), TSU.MinkowskiNet(**tiny)
    rng = np.random.RandomState(14)
    pts = np.concatenate([rng.uniform(0, 12, (300, 3)), rng.rand(300, 1)], 1).astype(np.float32)
    max_points = 400
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((max_points, 3)), jnp.zeros((max_points, 4)),
                            jnp.ones((max_points,), bool))
    params = random_params(shapes, 15)
    load_flax_params(tm, params)
    jitted = types.SimpleNamespace(apply=jax.jit(jm.apply), voxel_size=jm.voxel_size, max_voxels=jm.max_voxels)
    want_pred, want_col = JPT.segment_cloud(jitted, params, pts, max_points=max_points)
    got_pred, got_col = TPT.segment_cloud(tm.eval(), pts, max_points=max_points)
    np.testing.assert_array_equal(got_pred, want_pred)
    np.testing.assert_array_equal(got_col, want_col)
    np.testing.assert_array_equal(TPT.NUSC_COLORMAP, JPT.NUSC_COLORMAP)
    assert len(np.unique(got_pred)) > 1


def test_ptv3_segmenter_names_pointcept():
    with pytest.raises(ImportError, match="pointcept"):
        TPT.PTv3Segmenter("config.py")
