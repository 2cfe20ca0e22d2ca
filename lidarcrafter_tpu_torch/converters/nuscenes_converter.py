"""nuScenes → info-pkl converter (data pipeline step 1).

Port of the JAX package's ``tools/converters/nuscenes_converter.py``, which
mirrors the reference's ``tools/data_converter/nuscenes_converter.py``
(``create_nuscenes_infos``).  Requires the nuScenes devkit and the raw
dataset on disk (a gated import); the frame-change math is devkit-free and
tested in ``datasets/converter.py``.  Host numpy, no device.

Usage::

  python -m lidarcrafter_tpu_torch.converters.nuscenes_converter --root data/nuscenes \\
      [--version v1.0-trainval] [--fut-ts 12] [--ego-fut-ts 6] -o data/infos
"""

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..datasets.converter import (
    NUSC_NAME_MAPPING,
    agent_future_offsets,
    assemble_gt_boxes,
    classify_motion,
    ego_future_to_lidar,
    geom2anno,
    local_coords_to_global,
    quaternion_to_matrix,
    velocity_global_to_lidar,
)


def get_available_scenes(nusc):
    """Scenes whose lidar files exist; cf. ``nuscenes_converter.py:157-195``."""
    available = []
    for scene in nusc.scene:
        sample = nusc.get("sample", scene["first_sample_token"])
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        lidar_path = nusc.get_sample_data(sd["token"])[0]
        if Path(lidar_path).exists():
            available.append(scene)
    return available


def fill_infos(nusc, predict_helper, samples, fut_ts, ego_fut_ts, map_extractor=None):
    """cf. ``_fill_trainval_infos`` (``nuscenes_converter.py:197-459``)."""
    infos = []
    for sample in samples:
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(sample["data"]["LIDAR_TOP"])

        info = {
            "token": sample["token"],
            "lidar_path": str(lidar_path),
            "timestamp": sample["timestamp"],
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "prev_info": (
                {"valid": True, "token": sample["prev"]}
                if sample["prev"]
                else {"valid": False}
            ),
        }
        l2e_r = quaternion_to_matrix(cs["rotation"])
        e2g_r = quaternion_to_matrix(pose["rotation"])
        if map_extractor is not None:
            geoms = map_extractor.get_map_geom(
                nusc.get("log", nusc.get("scene", sample["scene_token"])["log_token"])["location"],
                np.asarray(pose["translation"]), np.asarray(pose["rotation"]),
            )
            info["map_annos"] = geom2anno(geoms)

        annotations = [nusc.get("sample_annotation", t) for t in sample["anns"]]
        locs = np.array([b.center for b in boxes]).reshape(-1, 3)
        dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
        yaws = np.array([b.orientation.yaw_pitch_roll[0] for b in boxes])
        velocity = np.array(
            [nusc.box_velocity(t)[:2] for t in sample["anns"]]
        ).reshape(-1, 2)
        velocity = velocity_global_to_lidar(velocity, e2g_r, l2e_r)
        names = np.array(
            [NUSC_NAME_MAPPING.get(b.name, b.name) for b in boxes]
        )
        valid_flag = np.array(
            [(a["num_lidar_pts"] + a["num_radar_pts"]) > 0 for a in annotations],
            bool,
        )

        num_box = len(boxes)
        fut_trajs = np.zeros((num_box, fut_ts, 2))
        fut_masks = np.zeros((num_box, fut_ts))
        fut_states = []
        for i, anno in enumerate(annotations):
            local = predict_helper.get_future_for_agent(
                anno["instance_token"], sample["token"],
                seconds=fut_ts / 2, in_agent_frame=True,
            )
            fut_states.append(classify_motion(local))
            if local.shape[0] > 0:
                scene_traj = local_coords_to_global(
                    local, boxes[i].center, boxes[i].rotation_matrix
                )
                fut_trajs[i], fut_masks[i] = agent_future_offsets(
                    scene_traj, boxes[i].center, fut_ts
                )

        # ego future (global chain of LIDAR_TOP poses)
        ego_global = np.zeros((ego_fut_ts + 1, 3))
        cur = sample
        for i in range(ego_fut_ts + 1):
            sd_i = nusc.get("sample_data", cur["data"]["LIDAR_TOP"])
            ego_global[i] = nusc.get("ego_pose", sd_i["ego_pose_token"])["translation"]
            if cur["next"] == "":
                ego_global[i + 1:] = ego_global[i]
                break
            cur = nusc.get("sample", cur["next"])
        ego_trajs, command, ego_state = ego_future_to_lidar(
            ego_global, pose["translation"], pose["rotation"],
            cs["translation"], cs["rotation"],
        )

        info.update(
            gt_boxes=assemble_gt_boxes(locs, dims, yaws),
            gt_names=names,
            gt_velocity=velocity,
            num_lidar_pts=np.array([a["num_lidar_pts"] for a in annotations]),
            num_radar_pts=np.array([a["num_radar_pts"] for a in annotations]),
            valid_flag=valid_flag,
            gt_agent_fut_trajs=fut_trajs.astype(np.float32),
            gt_agent_fut_masks=fut_masks.astype(np.float32),
            gt_agent_fut_states=fut_states,
            gt_ego_fut_trajs=ego_trajs[:, :2].astype(np.float32),
            gt_ego_fut_cmd=command,
            gt_ego_fut_state=ego_state,
        )
        infos.append(info)
    return infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--fut-ts", type=int, default=12)
    p.add_argument("--ego-fut-ts", type=int, default=6)
    p.add_argument("-o", "--output-dir", default="data/infos")
    p.add_argument("--with-maps", action="store_true")
    args = p.parse_args(argv)

    try:
        from nuscenes import NuScenes
        from nuscenes.prediction import PredictHelper
        from nuscenes.utils import splits
    except ImportError:
        raise SystemExit(
            "nuScenes devkit not installed — this converter needs it plus the "
            "raw dataset; the frame-change math is available (and tested) in "
            "lidarcrafter_tpu_torch.datasets.converter regardless."
        )

    nusc = NuScenes(version=args.version, dataroot=args.root, verbose=True)
    helper = PredictHelper(nusc)
    scene_names = {
        "train": splits.train if "trainval" in args.version else splits.mini_train,
        "val": splits.val if "trainval" in args.version else splits.mini_val,
    }
    available = {s["name"]: s["token"] for s in get_available_scenes(nusc)}
    map_extractor = None
    if args.with_maps:
        from ..datasets.map_extractor import NuscMapExtractor

        map_extractor = NuscMapExtractor(args.root, (60, 30))

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for split, names in scene_names.items():
        tokens = {available[n] for n in names if n in available}
        samples = [s for s in nusc.sample if s["scene_token"] in tokens]
        samples.sort(key=lambda s: (s["scene_token"], s["timestamp"]))
        infos = fill_infos(nusc, helper, samples, args.fut_ts, args.ego_fut_ts,
                           map_extractor)
        path = out / f"nuscenes_infos_{split}.pkl"
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        print(f"{split}: {len(infos)} infos → {path}")


if __name__ == "__main__":
    main()
