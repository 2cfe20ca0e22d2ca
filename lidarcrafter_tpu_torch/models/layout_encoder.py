"""Layout transformer encoder (CLIP-ViT style), port of the JAX package's
``models/layout_encoder.py``: ``LayoutTransformerEncoder`` and its v5
variant ``LayoutTransformerEncoderV5``.

Encodes up to ``layout_length`` objects (class embedding + 3D-box linear +
2D-box linear, + a linear of the flattened ``obj_mask`` where that condition
is used) through a pre-LN transformer and returns the dict the layout
UNet consumes: ``xf_out`` (B, L, hidden), ``xf_proj`` (B, output_dim),
``obj_class_embedding`` / ``obj_bbox_embedding`` (B, L, hidden),
``image_patch_bbox_embedding_for_resolution{H/ds}`` (B, L1, hidden),
``key_padding_mask`` (B, L) and the ``concat_cond`` passthrough.

The 13-token attention stays plain PyTorch: the JAX package has no kernel
there.  LayerNorms use flax's epsilon 1e-6 (PyTorch's default is 1e-5).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import softmax_f32_math
from .point_unet import ObjectGenEncoder

LN_EPS = 1e-6  # flax nn.LayerNorm


class QKVAttention(nn.Module):
    """Packed-QKV multi-head attention (per-head [q|k|v] packing)."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.c_qkv = nn.Linear(width, 3 * width)
        self.c_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        B, L, width = x.shape
        ch = width // self.num_heads
        qkv = self.c_qkv(x).reshape(B, L, self.num_heads, 3 * ch)
        q, k, v = qkv.split(ch, dim=-1)
        scale = float(1.0 / np.sqrt(np.sqrt(ch)))
        logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        weights = softmax_f32_math(logits)
        out = torch.einsum("bhts,bshc->bthc", weights, v).reshape(B, L, width)
        return self.c_proj(out)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + MLP residual block with exact GELU."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = QKVAttention(width, num_heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), key_padding_mask)
        return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)), approximate="none"))


def image_patch_bboxes(feature_map_size: Sequence[int], ds: int) -> np.ndarray:
    """Normalized (x1, y1, x2, y2) of each feature-map patch at downsample
    ``ds``, row-major (rows sweep H, columns sweep W)."""
    nh = int(feature_map_size[0] / ds)
    nw = int(feature_map_size[1] / ds)
    ii, jj = 1.0 / nh, 1.0 / nw
    out = [
        (jj * j, ii * i, jj * (j + 1), ii * (i + 1))
        for i in range(nh)
        for j in range(nw)
    ]
    return np.asarray(out, np.float32)  # (nh*nw, 4)


class LayoutTransformerEncoder(nn.Module):
    def __init__(
        self,
        feature_map_size: Sequence[int] = (32, 1024),
        layout_length: int = 13,
        hidden_dim: int = 64,
        output_dim: int = 256,
        num_layers: int = 6,
        num_heads: int = 4,
        use_final_ln: bool = True,
        num_classes_for_layout_object: int = 9,
        mask_size_for_layout_object: int = 32,
        used_condition_types: Sequence[str] = ("obj_class", "obj_bbox", "is_valid_obj"),
        use_positional_embedding: bool = False,
        resolution_to_attention: Sequence[int] = (),
        use_key_padding_mask: bool = False,
        not_use_layout_fusion_module: bool = False,
        fov_up: float = 10.0,  # config keys the JAX package does not read either
        fov_down: float = -30.0,
        out_channels: int = 10,  # concat-cond channels consumed by the UNet
    ):
        super().__init__()
        self.feature_map_size = tuple(feature_map_size)
        self.used_condition_types = tuple(used_condition_types)
        self.use_key_padding_mask = use_key_padding_mask
        self.num_layers = 0 if not_use_layout_fusion_module else num_layers
        if use_positional_embedding:
            self.positional_embedding = nn.Parameter(torch.randn(layout_length, hidden_dim))
        else:
            self.positional_embedding = None
        if "obj_class" in self.used_condition_types:
            self.obj_class_embedding = nn.Embedding(num_classes_for_layout_object, hidden_dim)
        self.patch_keys = []
        if "obj_bbox" in self.used_condition_types:
            self.obj_bbox_embedding = nn.Linear(8, hidden_dim)
            self.obj_bbox_2d_embedding = nn.Linear(4, hidden_dim)
            for ds in resolution_to_attention:
                r = int(self.feature_map_size[0] / ds)
                self.register_buffer(
                    f"patch_bboxes_{r}",
                    torch.as_tensor(image_patch_bboxes(self.feature_map_size, ds)),
                    persistent=False,
                )
                self.patch_keys.append(r)
        if "obj_mask" in self.used_condition_types:
            # over each object's flattened (mask_size, mask_size) mask
            self.obj_mask_embedding = nn.Linear(mask_size_for_layout_object ** 2, hidden_dim)
        for i in range(self.num_layers):
            self.add_module(f"resblock{i}", ResidualAttentionBlock(hidden_dim, num_heads))
        self.final_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS) if use_final_ln else None
        self.transformer_proj = nn.Linear(hidden_dim, output_dim)

    def patch_embeddings(self, outputs: dict, batch: int, dtype: torch.dtype) -> None:
        """The normalised patch boxes of each attention resolution through
        the 2D-box projection, broadcast over the batch, into ``outputs``."""
        for r in self.patch_keys:
            # the patch boxes are a float32 buffer; under bf16 AMP the
            # projection's weight is bf16
            boxes = getattr(self, f"patch_bboxes_{r}").to(dtype)
            emb = self.obj_bbox_2d_embedding(boxes)
            outputs[f"image_patch_bbox_embedding_for_resolution{r}"] = emb[None].expand(batch, -1, -1)

    def fuse(self, outputs: dict, xf_in: torch.Tensor) -> None:
        """The transformer over the layout tokens: ``xf_out`` and the pooled
        (token 0) ``xf_proj`` into ``outputs``."""
        kpm = outputs.get("key_padding_mask") if self.use_key_padding_mask else None
        xf_out = xf_in
        for i in range(self.num_layers):
            xf_out = self.get_submodule(f"resblock{i}")(xf_out, kpm)
        if self.final_ln is not None:
            xf_out = self.final_ln(xf_out)
        outputs["xf_proj"] = self.transformer_proj(xf_out[:, 0])
        outputs["xf_out"] = xf_out

    def forward(self, condition_dict: dict) -> dict:
        obj_bbox = condition_dict["scaled_gt_boxes"][..., :8]
        obj_bbox_2d = condition_dict["gt_boxes_2d"]
        obj_class = condition_dict["scaled_gt_boxes"][..., -1]
        is_valid_obj = condition_dict["is_valid_obj"]
        B = obj_bbox.shape[0]

        outputs: dict = {}
        xf_in = None
        if self.positional_embedding is not None:
            xf_in = self.positional_embedding[None].expand(B, -1, -1)
        if "obj_class" in self.used_condition_types:
            cls_emb = self.obj_class_embedding(obj_class.to(torch.int64))
            xf_in = cls_emb if xf_in is None else xf_in + cls_emb
            outputs["obj_class_embedding"] = cls_emb
        if "obj_bbox" in self.used_condition_types:
            emb3d = self.obj_bbox_embedding(obj_bbox)
            emb2d = self.obj_bbox_2d_embedding(obj_bbox_2d)
            xf_in = emb3d + emb2d if xf_in is None else xf_in + emb3d + emb2d
            outputs["obj_bbox_embedding"] = emb2d
            self.patch_embeddings(outputs, B, emb2d.dtype)
        if "obj_mask" in self.used_condition_types:
            m = condition_dict["obj_mask"]
            memb = self.obj_mask_embedding(m.reshape(*m.shape[:2], -1))
            xf_in = memb if xf_in is None else xf_in + memb
        if "is_valid_obj" in self.used_condition_types:
            outputs["key_padding_mask"] = (1 - is_valid_obj).to(torch.bool)

        self.fuse(outputs, xf_in)
        if "concat_cond" in condition_dict:
            if "autoregressive_cond" in condition_dict:
                outputs["concat_cond"] = torch.cat(
                    [condition_dict["concat_cond"], condition_dict["autoregressive_cond"]], dim=-1
                )
            else:
                outputs["concat_cond"] = condition_dict["concat_cond"]
        return outputs


class LayoutTransformerEncoderV5(LayoutTransformerEncoder):
    """The v5 encoder (``nuscenes-box-layout-v5``): the 3D-box linear
    embedding becomes an :class:`ObjectGenEncoder` over the per-object box
    encoding and the class's text feature, and ``autoregressive_cond`` is
    not concatenated.  Besides the base inputs, ``condition_dict`` carries
    ``fg_encoding_box`` (B, L, 8) and ``fg_text_features`` (9, 512), the
    CLIP class table (class 0 = unknown)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        h = self.obj_bbox_2d_embedding.out_features
        del self.obj_bbox_embedding
        self.obj_bbox_3d_embedding = ObjectGenEncoder(
            num_class=self.obj_class_embedding.num_embeddings, input_dim=8,
            proj_dims=(h * 8, h * 4, h * 4, h),
        )

    def forward(self, condition_dict: dict) -> dict:
        obj_class = condition_dict["scaled_gt_boxes"][..., -1]
        B = obj_class.shape[0]
        outputs: dict = {}
        cls_emb = self.obj_class_embedding(obj_class.to(torch.int64))
        outputs["obj_class_embedding"] = cls_emb
        emb2d = self.obj_bbox_2d_embedding(condition_dict["gt_boxes_2d"])
        emb3d = self.obj_bbox_3d_embedding({
            "fg_encoding_box": condition_dict["fg_encoding_box"],
            "fg_class": obj_class,
            "fg_text_features": condition_dict["fg_text_features"],
        })
        outputs["obj_bbox_embedding"] = emb2d
        self.patch_embeddings(outputs, B, emb2d.dtype)
        outputs["key_padding_mask"] = (1 - condition_dict["is_valid_obj"]).to(torch.bool)
        self.fuse(outputs, cls_emb + emb3d + emb2d)
        if "concat_cond" in condition_dict:
            outputs["concat_cond"] = condition_dict["concat_cond"]
        return outputs
