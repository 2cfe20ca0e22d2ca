"""Patch info pkls with per-sample lidarseg label paths.

Port of the JAX package's ``tools/converters/add_lidarseg.py``, which mirrors
``tools/data_converter/add_lidarseg_token.py`` (:8-26): for each info's
sample token, look up the LIDAR_TOP sample_data and record the nuScenes
``lidarseg`` filename as ``gt_segment_path`` — the label source for the
RangeNet semantic trainer (``datasets/seg_dataset.py`` reads it).

Requires the nuScenes devkit + dataset (gated import, like the other
converter steps); the patching logic itself is devkit-free and unit-tested
against a fake devkit object.

Usage::

  python -m lidarcrafter_tpu_torch.converters.add_lidarseg --root data/nuscenes \
      --infos data/infos/nuscenes_infos_val.pkl [--version v1.0-trainval]
"""

import argparse
import pickle
from pathlib import Path


def patch_infos_with_lidarseg(infos, nusc) -> int:
    """Add ``gt_segment_path`` to each info in place; returns the number
    patched.  ``nusc`` needs ``get(table, token)`` only
    (cf. ``add_lidarseg_token.py:15-21``)."""
    n = 0
    items = infos["infos"] if isinstance(infos, dict) and "infos" in infos else infos
    for info in items:
        sample = nusc.get("sample", info["token"])
        sd_token = sample["data"]["LIDAR_TOP"]
        seg = nusc.get("lidarseg", sd_token)
        if seg is None:
            continue
        info["gt_segment_path"] = seg["filename"]
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True)
    p.add_argument("--infos", required=True, nargs="+",
                   help="info pkl(s) to patch in place")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args(argv)

    try:
        from nuscenes import NuScenes
    except ImportError:
        raise SystemExit("nuScenes devkit not installed — needed to look up "
                         "lidarseg filenames (add_lidarseg_token.py parity)")

    nusc = NuScenes(version=args.version, dataroot=args.root, verbose=True)
    for path in args.infos:
        with open(path, "rb") as f:
            infos = pickle.load(f)
        n = patch_infos_with_lidarseg(infos, nusc)
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        print(f"{Path(path).name}: {n} infos patched with gt_segment_path")


if __name__ == "__main__":
    main()
