"""Object-uncertainty dataset and its 10-fold split, for GLENet and RGF.

Port of the JAX package's ``datasets/object_uncertainty.py``, in numpy with
the same draws, so that a crop here equals the JAX package's bit for bit:
GLENet trains and evaluates per fold of KFold(10, shuffle, seed 42) over
the car / truck / bus crops; a crop is centred on its points' mean,
scaled by the car anchor (3.9, 1.6, 1.56) and resampled to 512 points with
replacement (training draws the scale, then the rotation, then the
resample, from ``rng`` in that order); the ground-truth box is encoded as
(centre / diagonal, log size / anchor, yaw).  RGF's evaluation keys are
``{index}_{index}`` of the crop's global index.
"""

from __future__ import annotations

import numpy as np

from .transforms import _rotate_points_along_z_np

CLASS_NAMES = ("car", "truck", "bus")
POINT_ANCHOR_SIZE = (3.9, 1.6, 1.56)
KEEP_NUM = 512
ANGLE_ROT_MAX = 0.78539816  # exp20.yaml ANGLE_ROT_MAX
SCALE_RANGE = (0.95, 1.05)  # exp20.yaml RANDOM_SCALE_RANGE


def kfold_val_indices(n: int, n_splits: int = 10, seed: int = 42) -> list:
    """The validation indices of each fold, as sklearn's ``KFold(n_splits,
    shuffle=True, random_state=seed)`` gives them: a seeded permutation cut
    into ``n % n_splits`` folds of ``n // n_splits + 1`` and then folds of
    ``n // n_splits``, each sorted."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out, cur = [], 0
    for s in sizes:
        out.append(np.sort(idx[cur : cur + s]))
        cur += s
    return out


def flatten_uncertainty_infos(infos, class_names=CLASS_NAMES) -> list:
    """A foreground info dict ({class: [records]}) flattened in dict order,
    or a flat list filtered by ``name``, keeping ``class_names``."""
    if isinstance(infos, dict):
        out = []
        for key, value in infos.items():
            if key in class_names:
                out.extend(value)
        return out
    return [info for info in infos if info["name"] in class_names]


def encode_gt_box(box7, x_mean, y_mean, z_mean, pos_shift=(0.0, 0.0), angle_rot=0.0, noise_scale=1.0,
                  flip=False):
    """Ground-truth box → the 7-d regression target."""
    dxa, dya, dza = POINT_ANCHOR_SIZE
    diagonal = float(np.sqrt(dxa**2 + dya**2))
    box = np.asarray(box7, np.float64)[:7].copy()
    if flip:
        box[6] = -box[6]
    box[:6] *= noise_scale
    box[0] = (-x_mean + pos_shift[0]) / diagonal
    box[1] = (-y_mean + pos_shift[1]) / diagonal
    box[2] = (-z_mean) / dza
    box[3] = np.log(box[3] / dxa)
    box[4] = np.log(box[4] / dya)
    box[5] = np.log(box[5] / dza)
    box[6] += angle_rot
    return box.astype(np.float32)


def decode_boxes(boxes) -> np.ndarray:
    """Undo the anchor encoding of (N, 7+) boxes: centres × diagonal (z ×
    anchor height), sizes exp(·) × anchor; the yaw as it is."""
    dxa, dya, dza = POINT_ANCHOR_SIZE
    diagonal = float(np.sqrt(dxa**2 + dya**2))
    out = np.asarray(boxes, np.float64).copy()
    out[:, 0] *= diagonal
    out[:, 1] *= diagonal
    out[:, 2] *= dza
    out[:, 3] = np.exp(out[:, 3]) * dxa
    out[:, 4] = np.exp(out[:, 4]) * dya
    out[:, 5] = np.exp(out[:, 5]) * dza
    return out.astype(np.float32)


class ObjectUncertaintyDataset:
    """One fold's GLENet dataset.

    ``infos``: crop records ({path or points, name, num_points_in_gt,
    box3d_lidar}); ``fold_idx`` picks the split and ``training`` its train
    or validation side; ``text_feat``: {class: (1, 512)} CLIP table;
    ``rng``: the ``RandomState`` of the augmentation and the resample
    (numpy's global state by default).
    """

    def __init__(self, infos, fold_idx, text_feat, training=True, point_dims=4, class_names=CLASS_NAMES,
                 rng=None):
        self.infos_all = flatten_uncertainty_infos(infos, class_names)
        folds = kfold_val_indices(len(self.infos_all))
        val_idx = folds[fold_idx]
        train_idx = np.setdiff1d(np.arange(len(self.infos_all)), val_idx)
        self.frame_ids = val_idx  # evaluation keys use the global index
        sel = train_idx if training else val_idx
        self.infos = [self.infos_all[i] for i in sel]
        self.training = training
        self.text_feat = text_feat
        self.point_dims = point_dims
        self.rng = rng if rng is not None else np.random

    def __len__(self):
        return len(self.infos)

    def _load_points(self, info):
        if "points" in info:  # in-memory records (tests, synthetic crops)
            return np.asarray(info["points"], np.float32)[:, :3].copy()
        pts = np.fromfile(info["path"], np.float32)
        return pts.reshape(-1, self.point_dims)[:, :3].copy()

    def __getitem__(self, index):
        info = self.infos[index]
        points = self._load_points(info)

        flip_mark, noise_scale = False, 1.0
        pos_shift, angle_rot = np.zeros(2), 0.0
        if self.training:
            noise_scale = self.rng.uniform(*SCALE_RANGE)
            points[:, :3] *= noise_scale
            angle_rot = (self.rng.rand(1)[0] - 0.5) / 0.5 * ANGLE_ROT_MAX
            points = _rotate_points_along_z_np(points[None], np.asarray([angle_rot]))[0]

        if points.shape[0] != 0:
            x_mean, y_mean, z_mean = points[:, :3].mean(axis=0)
        else:
            x_mean = y_mean = z_mean = 0.0

        dxa, dya, dza = POINT_ANCHOR_SIZE
        diagonal = np.sqrt(dxa**2 + dya**2)
        points[:, 0] = (points[:, 0] - x_mean + pos_shift[0]) / diagonal
        points[:, 1] = (points[:, 1] - y_mean + pos_shift[1]) / diagonal
        points[:, 2] = (points[:, 2] - z_mean) / dza

        if points.shape[0] != 0:
            points = points[self.rng.choice(points.shape[0], KEEP_NUM, replace=True)]
        else:
            points = np.zeros((KEEP_NUM, 3), np.float32)

        box7 = encode_gt_box(info["box3d_lidar"], x_mean, y_mean, z_mean, pos_shift, angle_rot, noise_scale,
                             flip_mark)
        box8 = np.concatenate([box7[:6], [np.sin(box7[6]), np.cos(box7[6])]]).astype(np.float32)
        out = {
            "points": points.astype(np.float32),  # (512, 3)
            "gt_boxes_input": box8,
            "gt_boxes": box7,
            "text_feat": np.asarray(self.text_feat[info["name"]], np.float32).reshape(-1),
        }
        if not self.training:
            out["frame_id"] = int(self.frame_ids[index])
        return out

    def batches(self, batch_size):
        """Collated batches (stacked numpy), in order."""
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, len(self)))]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
