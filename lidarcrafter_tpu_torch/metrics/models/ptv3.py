"""Point-cloud semantic segmentation: the PTv3 wrapper and the native path.

Port of the JAX package's ``metrics/models/ptv3.py``.  Upstream's PTv3 wraps
the external ``pointcept`` library: grid-subsample a cloud, segment it, map
the predictions back through the inverse index, argmax, colour.  Here:

* :class:`PTv3Segmenter` is that wrapper behind the same gated
  ``pointcept`` import (it raises ``ImportError`` naming pointcept where
  the library is absent, as the JAX package's does);
* :func:`segment_cloud` is the native path with the same subsample →
  segment → devoxelise-by-inverse contract on the port's
  :class:`~lidarcrafter_tpu_torch.metrics.extractor.sparse_unet.MinkowskiNet`
  (17-class nuScenes head), on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

# nuScenes 16-class palette (+ void)
NUSC_COLORMAP = np.array(
    [
        [0, 0, 0], [255, 120, 50], [255, 192, 203], [255, 255, 0],
        [0, 150, 245], [0, 255, 255], [255, 127, 0], [255, 0, 0],
        [255, 240, 150], [135, 60, 0], [160, 32, 240], [255, 0, 255],
        [139, 137, 137], [75, 0, 75], [150, 240, 80], [230, 230, 250],
        [0, 175, 0],
    ],
    np.uint8,
)


@torch.inference_mode()
def segment_cloud(model, points: np.ndarray, max_points: int = 65536):
    """Per-point semantic labels and colours of the first ``max_points``
    points: ``model`` (a MinkowskiNet) gives per-voxel ``output`` logits,
    and each point takes the label of the voxel it falls in (the model's
    own quantisation, repeated for its inverse map)."""
    from ...ops.sparse import voxelize

    device = next(model.parameters()).device
    pts = np.asarray(points, np.float32)[:max_points]
    n = len(pts)
    pad = np.zeros((max_points, 3), np.float32)
    pad[:n] = pts[:, :3]
    feats = np.zeros((max_points, 4), np.float32)
    feats[:n, :3] = pts[:, :3]
    if pts.shape[1] > 3:
        feats[:n, 3] = pts[:, 3]
    pad_t, feats_t = torch.as_tensor(pad, device=device), torch.as_tensor(feats, device=device)
    mask = torch.arange(max_points, device=device) < n

    logits = model(pad_t, feats_t, mask)["output"]
    inv = voxelize(pad_t, model.voxel_size, point_mask=mask, max_voxels=model.max_voxels)[3]
    pred = logits.argmax(-1)[inv[:n].long()].cpu().numpy()
    colors = NUSC_COLORMAP[np.clip(pred, 0, len(NUSC_COLORMAP) - 1)]
    return pred, colors


class PTv3Segmenter:
    """Upstream's PTv3 wrapper; needs the pointcept library."""

    def __init__(self, config_file: str, weight: str | None = None):
        try:
            from pointcept.engines.defaults import default_config_parser
            from pointcept.models import build_model
        except ImportError as e:
            raise ImportError(
                "PTv3Segmenter needs the external pointcept library (as upstream does); use segment_cloud() "
                "with a MinkowskiNet for the native path."
            ) from e

        self.cfg = default_config_parser(config_file, None)
        if weight is not None:
            self.cfg.weight = weight
        self.model = build_model(self.cfg.model)
        ckpt = torch.load(self.cfg.weight, map_location="cpu", weights_only=False)
        state = {(k[7:] if k.startswith("module.") else k): v for k, v in ckpt["state_dict"].items()}
        self.model.load_state_dict(state, strict=True)
        self.model.eval()

    def inference_one_sample(self, points: np.ndarray):
        import torch.nn.functional as F
        from pointcept.datasets import build_dataset, collate_fn

        dataset = build_dataset(self.cfg.data.val)
        data_dict = dataset.getitem_from_outline(dict(coord=points[:, :3], strength=points[:, 3].reshape(-1, 1)))
        input_dict = collate_fn([data_dict])
        with torch.no_grad():
            pred = self.model(input_dict)["seg_logits"]
            pred = F.softmax(pred[data_dict["inverse"]], -1)
        pred = pred.max(1)[1].numpy()
        return pred, NUSC_COLORMAP[np.clip(pred, 0, len(NUSC_COLORMAP) - 1)]
