"""Object-classification train/val split (data pipeline step 6).

Port of the JAX package's ``tools/converters/split_object_dataset.py``, which
mirrors the reference's ``tools/data_converter/split_train_val_nusc_object.py``.

Usage::

  python -m lidarcrafter_tpu_torch.converters.split_object_dataset \
      --dbinfos data/infos/nuscenes_dbinfos_10sweeps_withvelo.pkl -o data/infos
"""

import argparse
import pickle
from pathlib import Path

from ..datasets.converter import split_object_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dbinfos", required=True)
    p.add_argument("-o", "--output-dir", default="data/infos")
    p.add_argument("--sample-num", type=int, default=10000)
    p.add_argument("--min-points", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with open(args.dbinfos, "rb") as f:
        fg_objects = pickle.load(f)
    train, val = split_object_dataset(
        fg_objects, sample_num=args.sample_num,
        min_points=args.min_points, seed=args.seed,
    )
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "nuscenes_object_classification_train.pkl", "wb") as f:
        pickle.dump(train, f)
    with open(out / "nuscenes_object_classification_val.pkl", "wb") as f:
        pickle.dump(val, f)
    print(f"Train data size: {len(train)}")
    print(f"Validation data size: {len(val)}")


if __name__ == "__main__":
    main()
