"""Dataset-side code: the point rotation and the 4D rollout's trajectories,
warps and point ops; the nuScenes-format datasets (``nuscenes``,
``nuscenes-object``, ``custom``, ``nuscenes-temporal``), the augmentor and
the threaded prefetch loader.

The registry's keys are the JAX package's ``__all_datasets__``; a config
whose ``data.dataset`` is not one of them (``kitti-360``'s
``kitti_360``) has no dataset here, as it has none there.
"""

from .custom_dataset import CustomDataset
from .nuscenes import NuscDataset
from .object_dataset import NuscObjectDataset
from .temporal_dataset import NuscTempDataset

__all_datasets__ = {
    "nuscenes": NuscDataset,
    "nuscenes-object": NuscObjectDataset,
    "custom": CustomDataset,
    "nuscenes-temporal": NuscTempDataset,
}


def make_dataset(cfg, **kw):
    """The registry's dataset for ``cfg.data.dataset``, built on ``cfg``."""
    key = cfg.data.dataset
    if key not in __all_datasets__:
        raise KeyError(f"no dataset {key!r} in the registry ({', '.join(sorted(__all_datasets__))})")
    return __all_datasets__[key](cfg, **kw)
