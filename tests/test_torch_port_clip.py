"""The CLIP text path of the PyTorch port against the JAX package's, on the
CPU: the byte-level BPE tokenizer on the synthetic merges table of
``tests/test_clip_text.py`` (ids exactly; the port's word scanner against
the ``regex`` package's split of CLIP's pattern), the text tower at narrow widths (1e-5 of
the largest feature; the JAX parameters carried across by the weight bridge
and, from OpenAI's names, by both packages' ``convert_clip_text``, which
must agree bit for bit), ``load_clip_text_encoder`` from a state dict and
from a TorchScript archive, and the scene-graph host code:
``build_scene_graph_info`` and ``SceneGraphAssigner`` with the same
``RandomState`` seed, data and a deterministic ``encode_fn`` (graphs, edits,
features, cache files and the collated batch exactly).
"""

from __future__ import annotations

import gzip
import pickle
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_harness import one_torch_thread, random_params  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu.datasets import scene_graph as JSG
from lidarcrafter_tpu.datasets.transforms import scale_boxes_3d as jax_scale_boxes_3d
from lidarcrafter_tpu.models import clip_text as JCT
from lidarcrafter_tpu.utils import clip_tokenizer as JTOK
from lidarcrafter_tpu.utils.torch_ckpt import convert_clip_text as jax_convert_clip_text
from lidarcrafter_tpu_torch.datasets import scene_graph as TSG
from lidarcrafter_tpu_torch.models import clip_text as TCT
from lidarcrafter_tpu_torch.utils import clip_tokenizer as TTOK
from lidarcrafter_tpu_torch.utils.torch_ckpt import convert_clip_text
from lidarcrafter_tpu_torch.weights import flax_to_state_dict

TOWER_RTOL = 1e-5
MERGES = ["#version: test", "c a", "ca r</w>", "t r", "u c", "tr uc", "truc k</w>", "w i", "wi l", "wil l</w>"]
TEXTS = [
    "a car will park", "truck will go straight", "car1 left truck2", "the ped's bike", "Big  TRUCK\tbehind   car",
    "&amp; 3 cars, 12 buses!", "café naïve — 東京 ✓", "x\x1cy <|endoftext|> z", "car " * 40, "",
]


@pytest.fixture(scope="module")
def bpe_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    gz, plain = d / "bpe.txt.gz", d / "bpe.txt"
    with gzip.open(gz, "wt") as f:
        f.write("\n".join(MERGES))
    plain.write_text("\n".join(MERGES))
    return gz, plain


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("form", ["gzip", "plain"])
def test_tokenizer_ids_equal_jax(form, bpe_paths):
    """The JAX tokenizer splits words with the ``regex`` package, the port
    with its scanner; the merges file gzipped or plain."""
    gz, plain = bpe_paths
    want = JTOK.CLIPTokenizer(gz)
    for path in [gz if form == "gzip" else plain]:
        got = TTOK.CLIPTokenizer(path)
        assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
        for text in TEXTS:
            assert got.encode(text) == want.encode(text), text
        np.testing.assert_array_equal(got.tokenize(TEXTS, 16), want.tokenize(TEXTS, 16))
        np.testing.assert_array_equal(got.tokenize(TEXTS), want.tokenize(TEXTS))
        assert got.decode(got.encode("a car will park")) == want.decode(want.encode("a car will park"))
    with pytest.raises(RuntimeError):
        TTOK.CLIPTokenizer(gz).tokenize(["car " * 50], context_length=8, truncate=False)


def test_scanner_splits_as_the_pattern():
    regex = pytest.importorskip("regex")
    pat = regex.compile(TTOK.PATTERN, regex.IGNORECASE)
    rnd = np.random.RandomState(0)
    alphabet = list("ab1'sdtlmrev <|>!,.\t\x1c") + ["<|endoftext|>", "'ll", "é", "東", "٣", "✓", " "]
    for _ in range(300):
        text = "".join(rnd.choice(alphabet, rnd.randint(0, 24)))
        assert TTOK.scan_words(text) == regex.findall(pat, text), repr(text)
    assert TTOK.bytes_to_unicode() == JTOK.bytes_to_unicode()


# -------------------------------------------------------------------- tower


VOCAB, CTX, WIDTH, HEADS, LAYERS, EMBED = 600, 24, 64, 4, 3, 48


def tokens(seed: int = 0, n: int = 3) -> np.ndarray:
    """SOT, random ids, EOT (the largest id), zero padding."""
    r = np.random.RandomState(seed)
    out = np.zeros((n, CTX), np.int64)
    for i in range(n):
        k = r.randint(3, CTX - 1)
        out[i, 0] = VOCAB - 2
        out[i, 1:k] = r.randint(1, VOCAB - 2, k - 1)
        out[i, k] = VOCAB - 1
    return out


def openai_state_dict(seed: int) -> dict:
    """Seeded weights under OpenAI CLIP's names (text tower and one
    ``visual.*`` key the converters skip)."""
    r = np.random.RandomState(seed)

    def t(*shape, scale=None):
        z = r.standard_normal(shape).astype(np.float32)
        return torch.as_tensor(z * (scale if scale is not None else 1 / np.sqrt(shape[-1])))

    sd = {"token_embedding.weight": t(VOCAB, WIDTH), "positional_embedding": t(CTX, WIDTH, scale=0.01),
          "ln_final.weight": 1 + t(WIDTH, scale=0.1), "ln_final.bias": t(WIDTH, scale=0.1),
          "text_projection": t(WIDTH, EMBED), "visual.proj": t(8, 8), "logit_scale": torch.tensor(4.6)}
    for i in range(LAYERS):
        p = f"transformer.resblocks.{i}"
        sd |= {f"{p}.attn.in_proj_weight": t(3 * WIDTH, WIDTH), f"{p}.attn.in_proj_bias": t(3 * WIDTH, scale=0.1),
               f"{p}.attn.out_proj.weight": t(WIDTH, WIDTH), f"{p}.attn.out_proj.bias": t(WIDTH, scale=0.1),
               f"{p}.ln_1.weight": 1 + t(WIDTH, scale=0.1), f"{p}.ln_1.bias": t(WIDTH, scale=0.1),
               f"{p}.mlp.c_fc.weight": t(4 * WIDTH, WIDTH), f"{p}.mlp.c_fc.bias": t(4 * WIDTH, scale=0.1),
               f"{p}.mlp.c_proj.weight": t(WIDTH, 4 * WIDTH), f"{p}.mlp.c_proj.bias": t(WIDTH, scale=0.1),
               f"{p}.ln_2.weight": 1 + t(WIDTH, scale=0.1), f"{p}.ln_2.bias": t(WIDTH, scale=0.1)}
    return sd


def jax_tower(**kw):
    return JCT.CLIPTextEncoder(vocab_size=VOCAB, context_length=CTX, width=WIDTH, heads=HEADS, layers=LAYERS,
                               embed_dim=EMBED, **kw)


def close(got, want, tol=TOWER_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def test_tower_matches_jax_through_the_bridge():
    """Random flax parameters → the port through ``flax_to_state_dict``."""
    jmodel = jax_tower()
    ids = tokens()
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32)), 3)
    tmodel = TCT.CLIPTextEncoder(VOCAB, CTX, WIDTH, HEADS, LAYERS, EMBED)
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel), strict=True)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        close(tmodel(torch.as_tensor(ids)), want)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_openai_names_convert_as_jax():
    """Both packages' ``convert_clip_text`` from OpenAI's names: the same
    tensors bit for bit, ``visual.*`` and ``logit_scale`` skipped, and the
    towers' features within 1e-5."""
    sd = openai_state_dict(1)
    tmodel = TCT.CLIPTextEncoder(VOCAB, CTX, WIDTH, HEADS, LAYERS, EMBED)
    jparams = jax_convert_clip_text({k: v.numpy() for k, v in sd.items()})
    want_sd = flax_to_state_dict(jparams, tmodel)
    got_sd = convert_clip_text(sd)
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    tmodel.load_state_dict(got_sd, strict=True)
    ids = tokens(2, 4)
    with torch.no_grad():
        close(tmodel(torch.as_tensor(ids)), jax.jit(jax_tower().apply)(jparams, jnp.asarray(ids, jnp.int32)))
    assert TCT.CLIPTextEncoder.dims_of(sd) == dict(vocab_size=VOCAB, context_length=CTX, width=WIDTH,
                                                   heads=WIDTH // 64, layers=LAYERS, embed_dim=EMBED)


class _Block(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.attn = nn.MultiheadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(width, 4 * width)),
                                              ("c_proj", nn.Linear(4 * width, width))]))
        self.ln_2 = nn.LayerNorm(width)


class _OpenAINames(nn.Module):
    """OpenAI CLIP's text-tower names, for a TorchScript archive."""

    def __init__(self):
        super().__init__()
        self.token_embedding = nn.Embedding(VOCAB, WIDTH)
        self.positional_embedding = nn.Parameter(torch.zeros(CTX, WIDTH))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([_Block(WIDTH, 1) for _ in range(LAYERS)])
        self.ln_final = nn.LayerNorm(WIDTH)
        self.text_projection = nn.Parameter(torch.zeros(WIDTH, EMBED))
        self.visual = nn.Linear(4, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.text_projection


def test_load_clip_text_encoder_from_state_dict_and_archive(tmp_path, bpe_paths):
    """A saved state dict and a TorchScript archive of the same weights
    through ``load_clip_text_encoder`` (CPU): the same features, within
    1e-5 of the JAX loader's from the state dict."""
    sd = openai_state_dict(4)
    plain = tmp_path / "clip_text.pt"
    torch.save({k: v for k, v in sd.items() if k != "logit_scale"}, plain)
    module = _OpenAINames()
    module.load_state_dict({k: v for k, v in sd.items() if not k.startswith(("visual", "logit"))}, strict=False)
    archive = tmp_path / "clip_script.pt"
    torch.jit.save(torch.jit.script(module), archive)
    gz, _ = bpe_paths
    texts = ["a car will park", "truck", "car1 left truck2"]
    jax_encode = JCT.load_clip_text_encoder(plain, gz, jit=False)[0]
    feats = []
    for path in (plain, archive):
        encode_fn, tok, model = TCT.load_clip_text_encoder(path, gz, device="cpu")
        assert isinstance(model, TCT.CLIPTextEncoder) and model.layers == LAYERS
        got = encode_fn(texts)
        assert got.shape == (3, EMBED) and got.dtype == torch.float32
        close(got, jax_encode(texts))
        feats.append(got)
    assert torch.equal(feats[0], feats[1])
    if not torch.cuda.is_available():  # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            TCT.load_clip_text_encoder(plain, gz)


# ----------------------------------------------------------- scene graphs


def scene_info(n: int, seed: int) -> dict:
    """A converter info dict of ``n`` boxes (one far out of range, one
    pedestrian with too few points)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n, 7))
    boxes[:, :2] = rng.uniform(-30, 30, (n, 2))
    boxes[:, 2] = rng.uniform(-2, 1, n)
    boxes[:, 3:6] = rng.uniform(1, 4, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[0, 0] = 500.0
    names = np.array(["car", "truck", "pedestrian", "car", "bus", "car", "bicycle"][:n])
    pts = np.full(n, 100)
    pts[2] = 10
    return {"gt_boxes": boxes, "gt_names": names, "num_lidar_pts": pts,
            "gt_agent_fut_trajs": rng.randn(n, 6, 2), "gt_agent_fut_masks": np.ones((n, 6)),
            "gt_agent_fut_states": np.array(["Stop", "Go Straight", "Turn Left", "Stop", "Stop", "Go", "Stop"][:n]),
            "instance_inds": np.arange(n), "gt_ego_fut_trajs": rng.randn(6, 2), "gt_ego_fut_masks": np.ones(6),
            "gt_ego_fut_state": "Go straight", "lidar_path": "x.bin"}


def assigner_sample(sg_module, info: dict) -> dict:
    sg = sg_module.build_scene_graph_info(info)["scene_graph"]
    return {"scaled_gt_boxes": jax_scale_boxes_3d(sg["keep_box"].copy()), "gt_fut_trajs": sg["keep_agent_fut_trajs"],
            "gt_fut_masks": sg["keep_agent_fut_masks"], "gt_names": sg["keep_box_names"],
            "gt_fut_states": sg["keep_agent_fut_states"], "gt_box_relationships": sg["keep_box_relationships"]}


def fake_clip(words):
    """Deterministic 512-d features of each word string."""
    return np.stack([np.random.RandomState(sum(map(ord, w)) % 2**31).randn(512) for w in words]).astype(np.float32)


def test_scene_graph_info_matches_jax():
    for seed in range(4):
        info = scene_info(7, seed)
        want, got = JSG.build_scene_graph_info(info), TSG.build_scene_graph_info(info)
        np.testing.assert_array_equal(TSG.mask_boxes_outside_range(info["gt_boxes"], (-80, -80, -8, 80, 80, 8)),
                                      JSG.mask_boxes_outside_range(info["gt_boxes"], (-80, -80, -8, 80, 80, 8)))
        assert set(got["scene_graph"]) == set(want["scene_graph"])
        for k, v in want["scene_graph"].items():
            np.testing.assert_array_equal(got["scene_graph"][k], v, err_msg=k)
    far = scene_info(3, 0)
    far["gt_boxes"][:, 0] = 500.0
    assert TSG.build_scene_graph_info(far)["scene_graph"] == {"valid": False}
    names = ["car", "truck", "car", "bus", "car"]
    assert TSG.unique_names(names) == JSG.unique_names(names)
    assert TSG.CHANGED_RELATIONSHIPS == JSG.CHANGED_RELATIONSHIPS


@pytest.mark.parametrize("split", ["train", "val"])
def test_assigner_matches_jax(split, tmp_path):
    """Same seed, same data, same ``encode_fn``: the same graphs and edits,
    features, cache files, and collated batch (edited relationships
    re-encoded); then the cache alone serves the same graphs.  The port's
    ``encode_fn`` returns a torch tensor, as the card's tower does."""
    samples = [assigner_sample(JSG, scene_info(7, s)) for s in range(12)]
    out = {}
    for name, mod, encode in (("jax", JSG, fake_clip), ("port", TSG, lambda w: torch.as_tensor(fake_clip(w)))):
        assigner = mod.SceneGraphAssigner(output_path=str(tmp_path / name), split=split, text_encode_fn=encode,
                                          rng=np.random.RandomState(3))
        items = [assigner.assign_item(i, s) for i, s in enumerate(samples)]
        out[name] = (items, mod.collate_scene_graphs(items, text_encode_fn=encode))
    (jitems, jbatch), (titems, tbatch) = out["jax"], out["port"]
    kinds = [it["manipulate"]["type"] for it in jitems]
    if split == "train":
        assert {"addition", "relationship"} <= set(kinds)
    else:
        assert set(kinds) == {"none"}
    for j, t in zip(jitems, titems):
        assert pickle.dumps(t, protocol=4) == pickle.dumps(j, protocol=4)
    for side in ("encoder", "decoder"):
        for k, v in jbatch[side].items():
            np.testing.assert_array_equal(tbatch[side][k], v, err_msg=f"{side}/{k}")
    for k in ("missing_nodes", "manipulated_subs", "manipulated_objs"):
        assert tbatch[k] == jbatch[k]
    files = sorted(p.name for p in (tmp_path / "jax" / split).iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port" / split).iterdir()) and files[0] == "CLIP_0000000.pkl"
    for f in files:
        assert (tmp_path / "port" / split / f).read_bytes() == (tmp_path / "jax" / split / f).read_bytes()
    cached = TSG.SceneGraphAssigner(output_path=str(tmp_path / "port"), split=split, rng=np.random.RandomState(3))
    for i, s in enumerate(samples):
        assert pickle.dumps(cached.assign_item(i, s), protocol=4) == pickle.dumps(titems[i], protocol=4)
    with pytest.raises(FileNotFoundError):
        TSG.SceneGraphAssigner(split=split).assign_item(0, samples[0])
