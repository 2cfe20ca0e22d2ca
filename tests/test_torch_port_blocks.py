"""Building blocks, LiDAR codecs, the weight bridge and the package rules of
the PyTorch port (``lidarcrafter_tpu_torch``), on the CPU.

Blocks get the same numpy-drawn weights as their flax counterparts through
the weight bridge.  Tolerance: float32 blocks of a few convolutions or
matmuls with O(1) values agree to 1e-5 of their largest output value.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import check_block, one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

import lidarcrafter_tpu.models.efficient_unet as jeu
import lidarcrafter_tpu.models.layout_unet as jlu
import lidarcrafter_tpu.models.ops as jops
from lidarcrafter_tpu.training import preprocess as jpre
from lidarcrafter_tpu.utils.lidar import LiDARUtility as JaxLiDARUtility
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator, generate_cond, main
from lidarcrafter_tpu_torch.kernels import loader
from lidarcrafter_tpu_torch.models import efficient_unet as teu
from lidarcrafter_tpu_torch.models import layout_unet as tlu
from lidarcrafter_tpu_torch.models import ops as tops
from lidarcrafter_tpu_torch.training import preprocess as tpre
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training
from lidarcrafter_tpu_torch.utils.lidar import LiDARUtility
from lidarcrafter_tpu_torch.weights import flax_to_state_dict

PORT_DIR = Path(__file__).resolve().parent.parent / "lidarcrafter_tpu_torch"


def _np(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize(
    "kernel,padding,ring,stride",
    [((3, 3), 1, True, 1), ((3, 3), 1, False, 1), ((1, 1), 0, False, 1), ((3, 3), 1, True, 2)],
)
def test_ring_conv(kernel, padding, ring, stride):
    x = _np(2, 8, 16, 6)
    check_block(
        jops.RingConv(5, kernel_size=kernel, padding=padding, ring=ring, stride=stride),
        tops.RingConv(6, 5, kernel_size=kernel, padding=padding, ring=ring, stride=stride),
        (x,),
    )


@pytest.mark.parametrize("up,down,ring", [(2, 1, True), (1, 2, True), (2, 1, False), (1, 2, False)])
def test_resample(up, down, ring):
    x = _np(2, 8, 16, 4)
    check_block(jops.Resample(up=up, down=down, ring=ring), tops.Resample(up=up, down=down, ring=ring), (x,))


def test_ring_pad_wraps_width_and_zero_pads_height():
    x = _np(1, 4, 6, 2)
    want = np.asarray(jops.ring_pad(jnp.asarray(x), (2, 1, 1, 3)))
    got = tops.ring_pad(torch.as_tensor(x), (2, 1, 1, 3)).numpy()
    np.testing.assert_array_equal(got, want)


def test_time_embedding():
    t = np.array([-15.0, 0.3, 14.0], np.float32)
    check_block(jeu.TimeEmbedding(32, 128), teu.TimeEmbedding(32, 128), (t,))


@pytest.mark.parametrize(
    "cin,cout,up,down,scale_shift",
    [(32, 64, False, False, True), (64, 64, False, True, True), (64, 64, True, False, True),
     (96, 32, False, False, False)],
)
def test_resblock_adm(cin, cout, up, down, scale_shift):
    x = _np(2, 8, 16, cin)
    emb = _np(2, 128, seed=1)
    check_block(
        jlu.ResBlockADM(cout, use_scale_shift_norm=scale_shift, up=up, down=down),
        tlu.ResBlockADM(cin, cout, 128, use_scale_shift_norm=scale_shift, up=up, down=down),
        (x, emb),
    )


def test_object_aware_cross_attention_block():
    B, H, W, C, enc, nh = 2, 4, 16, 64, 64, 2
    cond = {
        "image_patch_bbox_embedding_for_resolution4": _np(B, H * W, enc, seed=1),
        "obj_bbox_embedding": _np(B, 13, enc, seed=2),
        "obj_class_embedding": _np(B, 13, enc, seed=3),
        "xf_out": _np(B, 13, enc, seed=4),
    }
    check_block(
        jlu.ObjectAwareCrossAttention(num_heads=nh, encoder_channels=enc, resolution=4),
        tlu.ObjectAwareCrossAttention(C, nh, enc, resolution=4),
        (_np(B, H, W, C), cond),
    )


def _lidar_pair(resolution=(8, 32)):
    kw = dict(resolution=resolution, depth_format="log_depth", min_depth=1.45, max_depth=80.0)
    return JaxLiDARUtility.create(**kw), LiDARUtility.create(**kw)


def test_postprocess_sample_matches_jax():
    jl, tl = _lidar_pair()
    rnd = np.random.RandomState(0)
    sample = rnd.uniform(-1.1, 1.1, (2, 8, 32, 2)).astype(np.float32)
    want = jpre.postprocess_sample(jnp.asarray(sample), jl)
    got = tpre.postprocess_sample(torch.as_tensor(sample), tl)
    assert set(got) == set(want) == {"depth", "xyz", "reflectance"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_condition_preprocessing_matches_jax():
    jl, tl = _lidar_pair()
    rnd = np.random.RandomState(1)
    cm = np.stack(
        [rnd.randint(-1, 11, (2, 8, 32)), rnd.uniform(0, 90, (2, 8, 32))], axis=-1
    ).astype(np.float32)
    want = jpre.preprocess_condition_mask({"condition_mask": jnp.asarray(cm)}, jl, 8)
    got = tpre.preprocess_condition_mask({"condition_mask": torch.as_tensor(cm)}, tl, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jpre.preprocess_autoregressive_cond(jnp.asarray(cm[..., ::-1]), jl)
    got = tpre.preprocess_autoregressive_cond(torch.as_tensor(cm[..., ::-1].copy()), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ray_angles_match_jax():
    jl, tl = _lidar_pair((32, 1024))
    np.testing.assert_array_equal(tl.ray_angles.numpy(), np.asarray(jl.ray_angles))


def _small_unet_and_params():
    mod = tops.RingConv(3, 4)
    params = {"Conv_0": {"kernel": _np(3, 3, 3, 4), "bias": _np(4)}}
    return mod, params


def test_weight_bridge_converts_layouts():
    mod, params = _small_unet_and_params()
    sd = flax_to_state_dict({"params": params}, mod)
    np.testing.assert_array_equal(sd["conv_0.weight"].numpy(), params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    lin = torch.nn.Linear(3, 5)
    sd = flax_to_state_dict({"kernel": _np(3, 5), "bias": _np(5)}, lin)
    assert sd["weight"].shape == (5, 3)


def test_weight_bridge_raises_on_missing_extra_and_mismatched_leaves():
    mod, params = _small_unet_and_params()
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict({"Conv_0": {"kernel": params["Conv_0"]["kernel"]}}, mod)
    with pytest.raises(KeyError, match="left over"):
        flax_to_state_dict({**params, "Dense_7": {"kernel": _np(2, 2)}}, mod)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict({"Conv_0": {"kernel": _np(3, 3, 3, 5), "bias": _np(4)}}, mod)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "lidarcrafter_tpu"}
    sources = [p for p in sorted(PORT_DIR.rglob("*.py")) if "build" not in p.relative_to(PORT_DIR).parts]
    sources.append(PORT_DIR.parent / "chip_smoke.py")
    offenders = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert len(sources) > 20
    assert offenders == []


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfgs.get_config("nuscenes-box-layout-v6")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_diffusion_training(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        CondFrameGenerator(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cond(num_samples=1, num_steps=1, resolution=(32, 128))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "-n", "1", "--num-steps", "1", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_kernels()
    # asked for explicitly, the CPU runs the plain path end to end
    main(["-c", "nuscenes-auto-reg-v2", "--synthetic", "-n", "1", "--num-steps", "2",
          "--mode", "dpmpp_2m", "--resolution", "32", "128", "--device", "cpu",
          "-o", str(tmp_path)])
    depth = np.load(tmp_path / "cond_sample_0000_depth.npy")
    assert depth.shape == (32, 128, 1) and np.all(np.isfinite(depth))
