"""nuScenes info-pkl converter math (devkit-free core).

Copy of the JAX package's ``datasets/converter.py`` (host numpy), which
re-designs the pure computation of ``tools/data_converter/nuscenes_converter.py``
(644 LoC, step 1 of the reference's data pipeline): pose algebra, box/velocity
frame changes, motion-state labeling and future-trajectory offsets are plain
numpy here (unit-testable without the devkit); the devkit-touching assembly
lives in ``converters/nuscenes_converter.py`` behind a gated import.
"""

from __future__ import annotations

import math

import numpy as np

# cf. ``nuscenes_converter.py:27-43`` NameMapping
NUSC_NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

MAP_CLASSES = ("ped_crossing", "divider", "boundary")


def quaternion_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) → 3x3 rotation (the devkit's Quaternion.rotation_matrix)."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def quart_to_rpy(qua) -> tuple[float, float, float]:
    """(x, y, z, w) → roll/pitch/yaw; cf. ``nuscenes_converter.py:44-49``."""
    x, y, z, w = qua
    roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = math.asin(2 * (w * y - x * z))
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (z * z + y * y))
    return roll, pitch, yaw


def locate_message(utimes: np.ndarray, utime: float) -> int:
    """Nearest CAN-bus message index; cf. ``nuscenes_converter.py:51-55``."""
    i = int(np.searchsorted(utimes, utime))
    if i == len(utimes) or (i > 0 and utime - utimes[i - 1] < utimes[i] - utime):
        i -= 1
    return i


def velocity_global_to_lidar(
    velocity_xy: np.ndarray, e2g_r_mat: np.ndarray, l2e_r_mat: np.ndarray
) -> np.ndarray:
    """Global (N, 2) box velocities → lidar frame;
    cf. ``nuscenes_converter.py:335-340``."""
    v = np.concatenate(
        [velocity_xy, np.zeros((len(velocity_xy), 1))], axis=1
    )
    v = v @ np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    return v[:, :2]


def assemble_gt_boxes(
    locs: np.ndarray, wlh: np.ndarray, yaws: np.ndarray
) -> np.ndarray:
    """(N,3) centers + (N,3) w/l/h + (N,) yaw → (N, 7) [x y z l w h yaw]
    (dims reordered wlh→lwh; cf. ``nuscenes_converter.py:353``)."""
    return np.concatenate(
        [locs, wlh[:, [1, 0, 2]], np.asarray(yaws).reshape(-1, 1)], axis=1
    )


def classify_motion(fut_traj_local: np.ndarray, lat_thresh: float = 2.0,
                    stop_thresh: float = 0.5) -> str:
    """Agent-frame future → motion state; cf. ``nuscenes_converter.py:374-387``
    (lateral offset first, then travel distance)."""
    if fut_traj_local.shape[0] == 0:
        return "Unkonwn"  # reference spelling kept for pkl parity
    distance = float(np.linalg.norm(fut_traj_local[-1] - fut_traj_local[0]))
    if fut_traj_local[-1][0] >= lat_thresh:
        return "Turn Right"
    if fut_traj_local[-1][0] <= -lat_thresh:
        return "Turn Left"
    if distance < stop_thresh:
        return "Stop"
    return "Go Straight"


def local_coords_to_global(coords: np.ndarray, translation: np.ndarray,
                           rotation_matrix: np.ndarray) -> np.ndarray:
    """Agent-frame (T, 2) coords → global (prediction-helper convention)."""
    out = coords @ rotation_matrix[:2, :2].T
    return out + np.asarray(translation)[:2]


def agent_future_offsets(
    fut_traj_scene: np.ndarray, center: np.ndarray, fut_ts: int
) -> tuple[np.ndarray, np.ndarray]:
    """Scene-frame future → per-step offsets + valid mask;
    cf. ``nuscenes_converter.py:392-397``."""
    trajs = np.zeros((fut_ts, 2))
    mask = np.zeros((fut_ts,))
    T = min(fut_traj_scene.shape[0], fut_ts)
    if T > 0:
        trajs[0] = fut_traj_scene[0] - np.asarray(center)[:2]
        trajs[1:T] = fut_traj_scene[1:T] - fut_traj_scene[: T - 1]
        mask[:T] = 1
    return trajs, mask


def ego_future_to_lidar(
    global_positions: np.ndarray,
    pose_translation: np.ndarray,
    pose_rotation_q: np.ndarray,
    cs_translation: np.ndarray,
    cs_rotation_q: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, str]:
    """(T+1, 3) global ego positions → lidar-frame step offsets (T, 3),
    one-hot drive command [right, left, straight] and state string;
    cf. ``nuscenes_converter.py:400-435``."""
    t = np.asarray(global_positions, np.float64) - np.asarray(pose_translation)
    t = t @ quaternion_to_matrix(pose_rotation_q)  # R_inv · x == x @ R
    t = (t - np.asarray(cs_translation)) @ quaternion_to_matrix(cs_rotation_q)
    distance = float(np.linalg.norm(t[-1] - t[0]))
    if t[-1][0] >= 2:
        command, state = np.array([1, 0, 0]), "Turn Right"
    elif t[-1][0] <= -2:
        command, state = np.array([0, 1, 0]), "Turn Left"
    elif distance < 0.5:
        command, state = np.array([0, 0, 1]), "Stop"
    else:
        command, state = np.array([0, 0, 1]), "Go Straight"
    return (t[1:] - t[:-1]), command.astype(np.float32), state


def geom2anno(map_geoms: dict) -> dict:
    """Map geometries → {class_label: [(P, 2) polylines]};
    cf. ``nuscenes_converter.py:57-70``.  Accepts shapely lines (``.coords``)
    or raw coordinate arrays."""
    vectors = {}
    for cls, geom_list in map_geoms.items():
        if cls in MAP_CLASSES:
            label = MAP_CLASSES.index(cls)
            vectors[label] = [
                np.array(getattr(g, "coords", g)) for g in geom_list
            ]
    return vectors


def split_object_dataset(
    fg_objects_dict: dict,
    positive_classes=("car", "truck", "bus"),
    sample_num: int = 10_000,
    min_points: int = 50,
    train_frac: float = 0.8,
    seed: int = 0,
) -> tuple[list, list]:
    """Object classification split (step 6);
    cf. ``tools/data_converter/split_train_val_nusc_object.py:6-44``:
    positive classes capped at ``sample_num`` each, the rest shared as
    negatives, 80/20 split after a per-class shuffle."""
    rng = np.random.RandomState(seed)
    train, val = [], []

    def add(samples, cap):
        samples = [s for s in samples if s["num_points_in_gt"] > min_points]
        order = rng.permutation(len(samples))
        samples = [samples[i] for i in order][:cap]
        k = int(len(samples) * train_frac)
        train.extend(samples[:k])
        val.extend(samples[k:])

    for name in positive_classes:
        add(fg_objects_dict.get(name, []), sample_num)
    negatives = [k for k in fg_objects_dict if k not in positive_classes]
    per_neg = sample_num // max(len(negatives), 1)
    for name in negatives:
        add(fg_objects_dict[name], per_neg)
    rng.shuffle(train)
    rng.shuffle(val)
    return train, val
