"""CLIP text tower (the ViT-B/32 text transformer).

Port of the JAX package's ``models/clip_text.py``: pre-LN blocks with one
fused qkv projection, QuickGELU, a causal additive mask, the softmax in
float32, pooling at the end-of-text token (the largest id, so the argmax of
the ids) and ``pooled @ text_projection`` with no transpose, as CLIP's
``encode_text``.  Submodules carry the JAX module's flax names
(``resblock{i}``, ``attn_in_proj``, ``attn_out_proj``, ``mlp_c_fc``,
``mlp_c_proj``, ``ln_1`` / ``ln_2``, ``ln_final``, ``token_embedding``,
``positional_embedding``, ``text_projection``), so ``weights.py``
carries the JAX tower's parameters across.  Attention is plain PyTorch:
the JAX tower computes it in einsums, outside any Pallas kernel.

:func:`load_clip_text_encoder` builds the tower from an OpenAI CLIP
checkpoint (a state dict or a TorchScript archive) and a BPE merges file,
and returns the ``text_encode_fn`` that ``SceneGraphAssigner`` and
``collate_scene_graphs`` take.  Defaults are the ViT-B/32 text-tower
dimensions (vocab 49,408, context 77, width 512, 8 heads, 12 layers,
512-d output).
"""

from __future__ import annotations

import math
import warnings
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x · sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: causal self-attention over one fused qkv projection
    (torch ``nn.MultiheadAttention``'s packing), then a QuickGELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn_in_proj = nn.Linear(width, 3 * width)
        self.attn_out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_c_fc = nn.Linear(width, 4 * width)
        self.mlp_c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        dh = C // self.heads
        q, k, v = (t.reshape(B, L, self.heads, dh).transpose(1, 2)
                   for t in self.attn_in_proj(self.ln_1(x)).chunk(3, dim=-1))
        logits = torch.einsum("bhtc,bhsc->bhts", q, k) / float(math.sqrt(dh)) + mask
        w = F.softmax(logits.float(), dim=-1).to(logits.dtype)
        o = torch.einsum("bhts,bhsc->bhtc", w, v).transpose(1, 2).reshape(B, L, C)
        x = x + self.attn_out_proj(o)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    """CLIP text tower: ``forward(tokens (B, L) int) → (B, embed_dim)``."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512, heads: int = 8,
                 layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        for i in range(layers):
            self.add_module(f"resblock{i}", ResidualAttentionBlock(width, heads))
        self.layers = layers
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @staticmethod
    def dims_of(sd: Mapping) -> dict:
        """The tower's dimensions from an OpenAI CLIP state dict, as the JAX
        loader infers them: CLIP's 64-wide heads, layers counted by their
        ``ln_1``."""
        width = sd["ln_final.weight"].shape[0]
        return {
            "vocab_size": sd["token_embedding.weight"].shape[0],
            "context_length": sd["positional_embedding"].shape[0],
            "width": width,
            "heads": width // 64,
            "layers": sum(1 for k in sd if k.endswith(".ln_1.weight")),
            "embed_dim": sd["text_projection"].shape[1],
        }

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:L]
        mask = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x, mask)
        x = self.ln_final(x)
        pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def load_torch_state_dict(ckpt_path) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP checkpoint as float32 tensors: a state dict
    (``torch.load``; ``{'state_dict': ...}`` unwrapped) or, when that fails,
    a TorchScript archive (``torch.jit.load``, as the official
    ``ViT-B-32.pt``).  The file is unpickled in full, so load only
    checkpoints from a trusted source."""
    try:
        with warnings.catch_warnings():  # torch.load of a TorchScript archive dispatches to torch.jit.load
            warnings.filterwarnings("ignore", message=".*TorchScript archive.*")
            obj = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    except RuntimeError:
        obj = torch.jit.load(ckpt_path, map_location="cpu")
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float() for k, v in obj.items()}


def load_clip_text_encoder(ckpt_path, bpe_path, device: str | torch.device = "cuda"):
    """A ready-to-call text tower on ``device`` (the card unless the caller
    asks for the CPU) from an OpenAI CLIP checkpoint and a BPE merges file
    (``bpe_simple_vocab_16e6.txt.gz``, plain or gzipped).

    Returns ``(encode_fn, tokenizer, model)``; ``encode_fn(list[str]) →
    (N, embed_dim)`` float32 on ``device``, a ``text_encode_fn`` for
    ``SceneGraphAssigner`` and ``collate_scene_graphs``."""
    from ..utils.clip_tokenizer import CLIPTokenizer
    from ..utils.torch_ckpt import convert_clip_text

    device = resolve_device(device)
    sd = {k: v for k, v in load_torch_state_dict(ckpt_path).items() if "visual." not in k}
    model = CLIPTextEncoder(**CLIPTextEncoder.dims_of(sd))
    model.load_state_dict(convert_clip_text(sd, model), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    tokenizer = CLIPTokenizer(bpe_path)

    @torch.inference_mode()
    def encode_fn(texts) -> torch.Tensor:
        tokens = tokenizer.tokenize(texts, model.context_length)
        return model(torch.as_tensor(np.asarray(tokens, np.int64)).to(device))

    return encode_fn, tokenizer, model
