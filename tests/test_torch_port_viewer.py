"""The port's browser viewer (``lidarcrafter_tpu_torch/viewer.py``) on the
CPU at a reduced size (32x64, 32 channels): the JAX viewer's five server
round trips (``tests/test_viewer.py``) against the port's server, and the
edited boxes rasterised into the concat condition as the JAX viewer's
``SamplerHub._cond_batch`` does, to 1e-6."""

import importlib.util
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu import configs as jcfgs
from lidarcrafter_tpu.training.factory import _make_lidar_utils as jax_lidar_utils
from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import viewer
from lidarcrafter_tpu_torch.training.factory import make_lidar_utils

_spec = importlib.util.spec_from_file_location("jax_tool_viewer", Path(__file__).resolve().parents[1] / "tools" / "viewer.py")
jax_viewer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_viewer)

RESOLUTION = (32, 64)
BOXES = [[10, 3, -0.5, 4.5, 2, 1.7, 0.3, 1], [18, -6, -0.4, 4.2, 1.9, 1.6, -1.2, 2]]
TIMEOUT = 300


@pytest.fixture(scope="module")
def server():
    httpd = viewer.serve(port=0, resolution=RESOLUTION, device="cpu", model_channels=32)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def _post(url, payload):
    req = urllib.request.Request(url + "/api/sample", data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_index_page(server):
    with urllib.request.urlopen(server + "/", timeout=30) as r:
        html = r.read().decode()
    assert "lidarcrafter-tpu viewer" in html
    assert viewer.CONFIGS == jax_viewer.CONFIGS
    for name in viewer.CONFIGS:
        assert name in html


def _check_frame(out):
    assert len(out["depth"]) == RESOLUTION[0] and len(out["depth"][0]) == RESOLUTION[1]
    assert len(out["reflectance"]) == RESOLUTION[0]
    assert out["restored_checkpoint"] is False
    assert np.isfinite(np.asarray(out["depth"])).all()
    assert all(len(p) == 3 for p in out["points"][:5])


@pytest.mark.parametrize("config", ["nuscenes-unet-uncond", "meanflow-nusc"])
def test_uncond_sample_roundtrip(server, config):
    out = _post(server, {"config": config, "steps": 2, "mode": "ddim", "seed": 1})
    _check_frame(out)
    assert _post(server, {"config": config, "steps": 2, "mode": "ddim", "seed": 1}) == out


def test_layout_cond_sample_with_boxes(server):
    out = _post(server, {"config": "nuscenes-box-layout-v6", "steps": 2, "mode": "ddim", "seed": 0, "boxes": BOXES})
    _check_frame(out)
    plain = _post(server, {"config": "nuscenes-box-layout-v6", "steps": 2, "mode": "ddim", "seed": 0})
    assert plain["depth"] != out["depth"]  # the boxes reach the condition


def test_autoreg_sample_roundtrip(server):
    _check_frame(_post(server, {"config": "nuscenes-auto-reg-v2", "steps": 2, "mode": "ddim", "seed": 0}))


def test_unknown_config_is_client_error(server):
    req = urllib.request.Request(server + "/api/sample", data=json.dumps({"config": "nope"}).encode(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 500


@pytest.mark.parametrize("boxes", [BOXES, None])
@pytest.mark.parametrize("name", viewer.COND)
def test_boxes_rasterise_as_jax(name, boxes):
    tcfg = tcfgs.apply_reduced_topology(tcfgs.get_config(name), resolution=RESOLUTION)
    jcfg = jcfgs.apply_reduced_topology(jcfgs.get_config(name), resolution=RESOLUTION)
    got = viewer.SamplerHub.cond_batch(tcfg, boxes, make_lidar_utils(tcfg), torch.device("cpu"))
    cp = jcfg.condition_model.params
    want = jax_viewer.SamplerHub._cond_batch(jcfg, jnp, 1, cp["layout_length"], cp["out_channels"], boxes,
                                             jax_lidar_utils(jcfg))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
    if boxes:
        assert (np.asarray(want["concat_cond"])[..., 1:-1] > 0).sum() > 10
