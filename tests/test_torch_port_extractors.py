"""The metric suite's feature extractors in the PyTorch port against the JAX
package, on the CPU: PointNet (k=16, 128 points) and RangeNet-21 (16x64)
and -53 (32x64) with numpy-seeded weights drawn over the JAX modules' init
trees and handed to the port through its weight bridge (``FrozenBN``'s
statistics under ``params``, the decoder's ``conv_kernel``); upstream's
torch weights (the pretrained folder's darknet names, the ``RangeNet`` and
``PointNet1`` state_dicts) read by the port's loaders and by the JAX
package's converters; the pretrained-folder loaders; the FRID descriptor.

Limits: forwards 1e-4 of max(1, the largest output); converted weights,
the feature positions and the loaders' state_dicts exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.metrics import pretrained as JP
from lidarcrafter_tpu.metrics.extractor import pointnet as JPN
from lidarcrafter_tpu.metrics.extractor import rangenet as JRN
from lidarcrafter_tpu_torch.metrics import pretrained as TP
from lidarcrafter_tpu_torch.metrics.extractor import pointnet as TPN
from lidarcrafter_tpu_torch.metrics.extractor import rangenet as TRN
from lidarcrafter_tpu_torch.weights import flax_to_state_dict, init_random_, load_flax_params

TOL = 1e-4


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def pointnet():
    jmodel = JPN.PointNetFeatureExtractor(k=16)
    x = np.random.RandomState(0).randn(2, 128, 3).astype(np.float32)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tmodel = load_flax_params(TPN.PointNetFeatureExtractor(k=16), params).eval()
    return jmodel, params, tmodel, x


def test_pointnet_matches_jax_through_the_bridge(pointnet):
    jmodel, params, tmodel, x = pointnet
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1808)
    assert_close(got, want)
    # FrozenBN's statistics arrive as the running buffers
    bn = params["params"]["stn"]["conv1"]["bn"]
    np.testing.assert_array_equal(tmodel.stn.conv1.bn.running_var.numpy(), bn["var"])
    np.testing.assert_array_equal(tmodel.stn.conv1.bn.running_mean.numpy(), bn["mean"])
    # and the tree flax's own init draws
    init = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))
    with torch.no_grad():
        got = load_flax_params(TPN.PointNetFeatureExtractor(k=16), init).eval()(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(jax.jit(jmodel.apply)(init, jnp.asarray(x))))


def upstream_pointnet_state_dict(tmodel):
    """Upstream ``PointNet1`` names and shapes (Conv1d (O, I, 1)) of the
    port's weights."""
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    out = {}
    names = [("stn.conv1", "feat.stn.conv1", "feat.stn.bn1", True), ("stn.conv2", "feat.stn.conv2", "feat.stn.bn2", True),
             ("stn.conv3", "feat.stn.conv3", "feat.stn.bn3", True), ("stn.fc1", "feat.stn.fc1", "feat.stn.bn4", False),
             ("stn.fc2", "feat.stn.fc2", "feat.stn.bn5", False), ("feat_conv1", "feat.conv1", "feat.bn1", True),
             ("feat_conv2", "feat.conv2", "feat.bn2", True), ("feat_conv3", "feat.conv3", "feat.bn3", True),
             ("fc1", "fc1", "bn1", False), ("fc2", "fc2", "bn2", False)]
    for ours, w, bn, conv in names:
        out[f"{w}.weight"] = sd[f"{ours}.dense.weight"][..., None] if conv else sd[f"{ours}.dense.weight"]
        out[f"{w}.bias"] = sd[f"{ours}.dense.bias"]
        for stat in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{stat}"] = sd[f"{ours}.bn.{stat}"]
        out[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
    for ours, theirs in (("stn.fc3", "feat.stn.fc3"), ("fc3", "fc3")):
        out[f"{theirs}.weight"], out[f"{theirs}.bias"] = sd[f"{ours}.weight"], sd[f"{ours}.bias"]
    return out


def test_pointnet_upstream_loader_matches_the_jax_converter(pointnet, tmp_path):
    jmodel, _, tmodel, x = pointnet
    upstream = upstream_pointnet_state_dict(tmodel)
    got = TPN.convert_pointnet_state_dict(upstream)
    want = flax_to_state_dict(JPN.convert_pointnet_state_dict(upstream), TPN.PointNetFeatureExtractor())
    assert_same_state(got, want)
    assert_same_state(got, tmodel.state_dict())
    # the folder loader, pretrained or absent
    assert TP.load_pointnet(tmp_path, device="cpu") is None
    (tmp_path / "shapenet").mkdir()
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in upstream.items()}},
               tmp_path / "shapenet" / "pointnet_cls.pth")
    apply = TP.load_pointnet(tmp_path, device="cpu")
    assert_close(apply(torch.from_numpy(x)).numpy(), np.asarray(JP.load_pointnet(tmp_path)(jnp.asarray(x))))


@pytest.fixture(scope="module")
def rangenet21():
    jmodel = JRN.RangeNet(num_classes=17, backbone=21)
    img = np.random.RandomState(2).rand(2, 16, 64, 5).astype(np.float32)
    img[:, ::3, ::5, 0] = 0.0  # empty pixels
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(img)), 3)
    tmodel = load_flax_params(TRN.RangeNet(num_classes=17, backbone=21), params).eval()
    jimg = JRN.preprocess_range_input(jnp.asarray(img))
    want = {f: jax.jit(functools.partial(jmodel.apply, feature=f))(params, jimg) for f in (None, "decoder")}
    want["lidargen"] = JRN.flatten_and_subsample(want["decoder"])  # the JAX model's lidargen path
    return jmodel, params, tmodel, img, want


@pytest.mark.parametrize("feature", [None, "decoder", "lidargen"])
def test_rangenet21_matches_jax_through_the_bridge(rangenet21, feature):
    _, _, tmodel, img, want = rangenet21
    want = np.asarray(want[feature])
    with torch.no_grad():
        got = tmodel(TRN.preprocess_range_input(nchw(img)), feature).numpy()
    if feature != "lidargen":
        got = got.transpose(0, 2, 3, 1)
    assert_close(got, want)


def test_transposed_conv_maps_onto_conv_transpose2d():
    """The decoder's ``lax.conv_transpose`` (kernel (1, 4), stride (1, 2),
    padding k - 1 - p) equals ``ConvTranspose2d`` with the bridge's
    (kh, kw, out, in) → (in, out, kh, kw) map; odd widths included."""
    jblock = JRN.ConvBNLReLU(6, (1, 4), (1, 2), (0, 1), transposed=True, use_bias=True)
    tblock = TRN.ConvBNLReLU(5, 6, (1, 4), (1, 2), (0, 1), transposed=True, use_bias=True)
    for w in (8, 13):
        x = np.random.RandomState(w).randn(2, 3, w, 5).astype(np.float32)
        for params in (random_params(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x)), 4),
                       jblock.init(jax.random.PRNGKey(w), jnp.asarray(x))):  # and flax's own init
            assert params["params"]["conv_kernel"].shape == (1, 4, 6, 5)
            load_flax_params(tblock, params)
            with torch.no_grad():
                got = tblock(nchw(x)).numpy().transpose(0, 2, 3, 1)
            assert got.shape == (2, 3, 2 * w, 6)
            assert_close(got, np.asarray(jblock.apply(params, jnp.asarray(x))))


def test_rangenet53_lidargen_and_frid_descriptor_match_jax():
    jmodel = JRN.RangeNet(num_classes=17, backbone=53)
    img = np.random.RandomState(5).rand(1, 32, 64, 5).astype(np.float32)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(img)), 6)
    tmodel = load_flax_params(TRN.RangeNet(num_classes=17, backbone=53), params).eval()
    assert len(tmodel.enc3.res7.expand.conv.weight) == 256
    with torch.no_grad():
        t_dec = tmodel(nchw(img), "decoder")
        t_feat = tmodel(nchw(img), "lidargen")
    j_dec = jax.jit(functools.partial(jmodel.apply, feature="decoder"))(params, jnp.asarray(img))
    assert_close(t_dec.numpy().transpose(0, 2, 3, 1), np.asarray(j_dec))
    assert_close(t_feat.numpy(), np.asarray(JRN.flatten_and_subsample(j_dec)))
    for agg in ("depth", "sector", "all"):
        assert_close(TRN.rangenet_frid_descriptor(t_dec, agg).numpy(),
                     np.asarray(JRN.rangenet_frid_descriptor(j_dec, agg)))


def test_feature_positions_are_upstreams_draw():
    """The 4,096 positions at the full-width size (32 channels x 32 x 1024)
    and at a test size, against the JAX package's ``random.seed(0)`` draw."""
    for c, h, w in ((32, 32, 1024), (2, 8, 256)):
        fm = np.arange(c * h * w, dtype=np.float32).reshape(1, c, h, w)
        got = TRN.flatten_and_subsample(torch.from_numpy(fm)).numpy()
        want = np.asarray(JRN.flatten_and_subsample(jnp.asarray(fm.transpose(0, 2, 3, 1))))
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == 4096


def darknet_folder(nrb, rnd, head=False):
    """A pretrained folder's darknet-named backbone and decoder state_dicts
    at full widths (and optionally the class head)."""
    b, d = {}, {}

    def conv(sd, name, o, i, kh, kw, bias=False):
        sd[f"{name}.weight"] = (rnd.randn(o, i, kh, kw) * 0.05).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = (rnd.randn(i if kh == 1 and kw == 4 else o) * 0.05).astype(np.float32)

    def bn(sd, p, c):
        sd[f"{p}.weight"] = rnd.rand(c).astype(np.float32) + 0.5
        sd[f"{p}.bias"] = (rnd.randn(c) * 0.1).astype(np.float32)
        sd[f"{p}.running_mean"] = (rnd.randn(c) * 0.1).astype(np.float32)
        sd[f"{p}.running_var"] = rnd.rand(c).astype(np.float32) + 0.5
        sd[f"{p}.num_batches_tracked"] = np.zeros((), np.int64)

    chans = [32, 64, 128, 256, 512, 1024]
    conv(b, "conv1", 32, 5, 3, 3)
    bn(b, "bn1", 32)
    for k in range(1, 6):
        ci, co = chans[k - 1], chans[k]
        conv(b, f"enc{k}.conv", co, ci, 3, 3)
        bn(b, f"enc{k}.bn", co)
        for j in range(nrb[k - 1]):
            p = f"enc{k}.residual_{j}"
            conv(b, f"{p}.conv1", ci, co, 1, 1)
            bn(b, f"{p}.bn1", ci)
            conv(b, f"{p}.conv2", co, ci, 3, 3)
            bn(b, f"{p}.bn2", co)
    for j in range(5, 0, -1):
        d0, d1 = chans[j], chans[j - 1]
        d[f"dec{j}.upconv.weight"] = (rnd.randn(d0, d1, 1, 4) * 0.05).astype(np.float32)
        d[f"dec{j}.upconv.bias"] = (rnd.randn(d1) * 0.05).astype(np.float32)
        bn(d, f"dec{j}.bn", d1)
        p = f"dec{j}.residual"
        conv(d, f"{p}.conv1", d0, d1, 1, 1)
        bn(d, f"{p}.bn1", d0)
        conv(d, f"{p}.conv2", d1, d0, 3, 3)
        bn(d, f"{p}.bn2", d1)
    h = None
    if head:
        h = {"head.1.weight": (rnd.randn(17, 32, 3, 3) * 0.05).astype(np.float32),
             "head.1.bias": (rnd.randn(17) * 0.05).astype(np.float32)}
    return b, d, h


@pytest.mark.parametrize("backbone,head", [(21, False), (21, True), (53, False)])
def test_rangenet_folder_loader_matches_the_jax_converter(backbone, head):
    b, d, h = darknet_folder(TRN.BACKBONES[backbone], np.random.RandomState(backbone), head)
    got = TRN.convert_rangenet_folder(b, d, h)
    model = TRN.RangeNet(num_classes=17, backbone=backbone)
    assert_same_state(got, flax_to_state_dict(JRN.convert_rangenet_folder(b, d, h), model))
    model.load_state_dict(got)
    # and back: the darknet names of the loaded model read in again
    b2, d2 = TRN.to_rangenet_folder(model.state_dict())
    assert_same_state(TRN.convert_rangenet_folder(b2, d2, h), got)


def upstream_rangenet_state_dict(tmodel):
    """Upstream ``RangeNet`` names (``stem.0`` / ``stem.1``,
    ``enc{k}.residual_blocks.{i}.residual.{0,1}.{0,1}``, ``head.1``) of the
    port's weights."""
    out = {}
    for key, v in tmodel.state_dict().items():
        parts = key.split(".")
        if parts[0] == "head":
            out[f"head.1.{parts[1]}"] = v.numpy()
            continue
        name, leaf = ".".join(parts[:-2]), parts[-2:]
        idx = "0" if leaf[0] == "conv" else "1"
        if name == "stem":
            up = "stem"
        elif name.endswith(".conv"):
            up = name
        else:
            block, res, part = name.split(".")
            up = f"{block}.residual_blocks.{res[3:]}.residual.{0 if part == 'reduce' else 1}"
        out[f"{up}.{idx}.{leaf[1]}"] = v.numpy()
    return out


def test_rangenet_state_dict_loader_matches_the_jax_converter(rangenet21):
    tmodel = rangenet21[2]
    upstream = upstream_rangenet_state_dict(tmodel)
    got = TRN.convert_rangenet_state_dict(upstream)
    assert_same_state(got, flax_to_state_dict(JRN.convert_rangenet_state_dict(upstream),
                                              TRN.RangeNet(num_classes=17, backbone=21)))
    assert_same_state(got, tmodel.state_dict())


def test_pretrained_rangenet_loader_matches_jax(rangenet21, tmp_path):
    """``load_rangenet_lidargen`` from ``{root}/32/rangenet`` (darknet
    names) gives the features of the model it was written from, which the
    JAX package's lidargen path gives too; None without the folder."""
    _, _, tmodel, img, want = rangenet21
    assert TP.load_rangenet_lidargen(tmp_path, device="cpu") is None
    folder = tmp_path / "32" / "rangenet"
    folder.mkdir(parents=True)
    b, d = TRN.to_rangenet_folder(tmodel.state_dict())
    torch.save(b, folder / "backbone")
    torch.save(d, folder / "segmentation_decoder")
    got = TP.load_rangenet_lidargen(tmp_path, device="cpu")(nchw(img)).numpy()
    with torch.no_grad():
        np.testing.assert_array_equal(got, tmodel(TRN.preprocess_range_input(nchw(img)), "lidargen").numpy())
    assert_close(got, np.asarray(want["lidargen"]))


def test_random_extractors_are_seeded():
    img = torch.rand(1, 5, 16, 64)
    pts = torch.randn(2, 64, 3)
    a, b = TP.random_rangenet_lidargen(3, device="cpu"), TP.random_rangenet_lidargen(3, device="cpu")
    assert a(img).shape == (1, 4096) and torch.equal(a(img), b(img))
    p = TP.random_pointnet(3, device="cpu")
    assert p(pts).shape == (2, 1808) and torch.equal(p(pts), TP.random_pointnet(3, device="cpu")(pts))
    assert not torch.equal(p(pts), TP.random_pointnet(4, device="cpu")(pts))
    # the random weights come from init_random_, not from torch's global generator
    torch.manual_seed(0)
    x = TP.random_pointnet(5, device="cpu")(pts)
    torch.manual_seed(1)
    assert torch.equal(x, TP.random_pointnet(5, device="cpu")(pts))
    model = init_random_(TPN.PointNetFeatureExtractor(), 5)
    assert torch.equal(model.eval()(pts), x)
