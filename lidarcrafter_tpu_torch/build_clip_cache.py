"""CLIP text-feature pipeline steps on the port's text tower.

Port of the JAX package's ``tools/converters/build_clip_cache.py``
(the reference's steps 3 and 4 of ``scripts/create_data.sh``):

- ``obj-text``: per-class text features → ``obj_text_feat.pkl`` (a dict of
  class name → (1, 512) float32 numpy array);
- ``warm-cache``: iterate a dataset split so that its ``SceneGraphAssigner``
  writes its ``CLIP_%07d.pkl`` cache.

Both read OpenAI CLIP weights (TorchScript ``.pt`` or a state dict) and the
``bpe_simple_vocab_16e6.txt.gz`` merges file through
``models/clip_text.py::load_clip_text_encoder``, on the card unless
``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.build_clip_cache obj-text --clip ViT-B-32.pt \\
      --bpe bpe_simple_vocab_16e6.txt.gz --save_path data/infos/obj_text_feat.pkl
  python -m lidarcrafter_tpu_torch.build_clip_cache warm-cache --clip ViT-B-32.pt \\
      --bpe bpe_simple_vocab_16e6.txt.gz --config nuscenes-layout --pkl data/infos/..._train.pkl
"""

from __future__ import annotations

import argparse
import pickle

from .configs import apply_override, get_config
from .datasets import make_dataset
from .models.clip_text import load_clip_text_encoder

# the reference's class list, with its 'unkonwn' spelling: the cache keys
# must match (generate_nusc_obj_text_feature.py:10)
CLASS_NAMES = (
    "unkonwn", "car", "truck", "construction_vehicle", "bus", "trailer",
    "motorcycle", "bicycle", "pedestrian",
)


def obj_text_features(encode_fn) -> dict:
    """Class name → its (1, D) text feature on the host."""
    feats = encode_fn(list(CLASS_NAMES)).cpu().numpy()
    return {name: feats[i:i + 1] for i, name in enumerate(CLASS_NAMES)}


def warm_cache(cfg, encode_fn, every: int = 500) -> int:
    """Read every item of ``cfg``'s dataset once, so that its assigner
    writes the CLIP features of each missing sample; returns the count."""
    ds = make_dataset(cfg)
    if not hasattr(ds, "scene_graph_assigner"):
        raise SystemExit(f"config task {cfg.data.task!r} builds no scene-graph assigner - use a "
                         "layout_generation config such as nuscenes-layout")
    ds.scene_graph_assigner.text_encode_fn = encode_fn
    for i in range(len(ds)):
        ds[i]
        if i % every == 0:
            print(f"warmed {i}/{len(ds)}")
    return len(ds)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cmd", choices=["obj-text", "warm-cache"])
    p.add_argument("--clip", required=True, help="CLIP checkpoint (.pt)")
    p.add_argument("--bpe", required=True, help="bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--save_path", default="data/infos/obj_text_feat.pkl")
    p.add_argument("--config", default="nuscenes-layout", help="a layout_generation config (warm-cache)")
    p.add_argument("--pkl", help="info pkl for warm-cache")
    p.add_argument("--data_root", default="data/nuscenes")
    p.add_argument("--split", default="train")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="config override (warm-cache), e.g. data.clip_cache_dir='\"/data/clips\"'")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    encode_fn, _, _ = load_clip_text_encoder(args.clip, args.bpe, device=args.device)
    if args.cmd == "obj-text":
        out = obj_text_features(encode_fn)
        with open(args.save_path, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"wrote {len(out)} class features -> {args.save_path}")
        return
    cfg = get_config(args.config)
    cfg.data.split = args.split
    cfg.data.data_root = args.data_root
    if args.pkl:
        cfg.data.pkl_path = args.pkl
    for spec in args.set:
        apply_override(cfg, spec)
    print(f"cache warmed for {warm_cache(cfg, encode_fn)} samples")


if __name__ == "__main__":
    main()
