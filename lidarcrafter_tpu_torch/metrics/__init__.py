"""The scene- and sequence-level metric suite, in PyTorch.

Port of the JAX package's ``metrics/``: chamfer, EMD, BEV JSD / MMD,
Fréchet distance and squared MMD over RangeNet and PointNet features
(``engine.py``, ``eval_suite.py``), and the sequence metrics TTCE and TCD
(``temporal.py``).  Every heavy op runs on the device of its inputs; the
entry points (``evaluate.py``, ``evaluate_temporal.py``) default to CUDA.

The constants are the port's own copy of the JAX package's.
"""

OUTPUT_TEMPLATE = 50 * "-" + "\n|" + 16 * " " + "{}:{:.4E}" + 17 * " " + "|\n" + 50 * "-"

VOXEL_SIZE = 0.5
DATA_CONFIG = {
    "64": {"x": [-50, 50], "y": [-50, 50], "z": [-3, 1]},
    "32": {"x": [-30, 30], "y": [-30, 30], "z": [-3, 6]},
}
DATASET_CONFIG = {
    "kitti": {"size": [64, 1024], "fov": [3, -25], "depth_range": [1.0, 56.0], "depth_scale": 6},
    "nuscenes": {"size": [32, 1024], "fov": [10, -30], "depth_range": [1.0, 45.0]},
}
TYPE2DATASET = {"32": "nuscenes", "64": "kitti"}

from . import bev, distribution, temporal  # noqa: E402,F401
from .eval_suite import evaluate  # noqa: E402,F401
