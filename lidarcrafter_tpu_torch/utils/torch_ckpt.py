"""Upstream PyTorch checkpoints → the port's modules.

Port of the JAX package's ``utils/torch_ckpt.py``.  The reference saves the
diffusion ENGINE's state dict in a ``.pth`` dict ``{'weights',
'ema_weights', 'cfg', ...}``, the denoiser under ``model.`` and the
condition encoder under ``condition_model.`` (``ema_model.`` in front when
the EMA module itself was saved).  The port's modules carry the flax names
(``weights.py``), so each family maps an upstream name straight onto a port
``state_dict`` key: a table ``port key → (upstream key, leaf rule)``, built
by replaying the JAX converter of the family (its block lists, and the
optional parts it reads where the checkpoint holds them).  Leaf rules:

- ``ID``: the tensor as it is (Conv2d OIHW, Linear (O, I), norms,
  embeddings, HDiT's raw leaves, CLIP's fused ``in_proj`` and its
  ``text_projection``, used as ``pooled @ proj``);
- ``rows(i, n)``: row block ``i`` of ``n`` of a packed
  ``nn.MultiheadAttention`` ``in_proj_*`` (the EfficientUNet attention's
  ``query`` / ``key`` / ``value`` Linears);
- ``TAP0``: a kernel-size-1 Conv1d (O, I, 1) read as a Linear (O, I);
- ``flat(k)``: a vector stored with ``k`` trailing unit axes, read flat
  (RefineNet's ``InstanceNorm2dPlus`` leaves; its post-affine weight is a
  depthwise 1x1 conv's);
- ``mid_tap(k)``: a Conv1d (O, I, k) read as a Linear from its middle tap
  (``UNet1DModel`` runs length-1 sequences, where SAME padding multiplies
  the other taps by zeros).

Ingestion is strict: it raises on an upstream key that the table reads and
the checkpoint lacks, on a port key that nothing fills or that the module
does not hold, and on a shape mismatch, naming the key.  It reads exactly
the upstream keys that the JAX converter reads; every other key (CLIP's
``visual.*``, the reference's unused ``obj_embeddings_dc``, BatchNorm's
``num_batches_tracked``) is skipped, as there.  Where the JAX route cannot
ingest a registry config (``nuscenes-box-layout-v5``: its converter reads
only the base encoder's keys), the port raises.

Run backwards, the same table gives the upstream names of a port module's
``state_dict`` (:func:`to_upstream_checkpoint`): tests and ``chip_smoke.py``
build upstream-format checkpoints from seeded port modules with it.  It
is no entry point: a real checkpoint comes from upstream.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

ID = ("id",)
TAP0 = ("tap0",)


def rows(i: int, n: int) -> tuple:
    return ("rows", i, n)


def flat(k: int) -> tuple:
    """A vector stored upstream with ``k`` trailing unit axes."""
    return ("flat", k)


def mid_tap(k: int) -> tuple:
    return ("mid_tap", k)


class _Table:
    """``port key → (upstream key, rule)`` of one module, built against the
    upstream key set (ingestion: an optional part is mapped where the
    checkpoint holds it, as the JAX converter reads it) or against the port
    key set (export: where the module holds it)."""

    def __init__(self, upstream=None, port=None):
        self.ingest = upstream is not None
        self.keys = set(upstream if self.ingest else port)
        self.map: dict[str, tuple[str, tuple]] = {}

    def has(self, up: str, port: str) -> bool:
        return (up if self.ingest else port) in self.keys

    def ids(self, up_re: str, port_re: str) -> list[str]:
        """The distinct first groups of a pattern over the key set."""
        pat = re.compile(up_re if self.ingest else port_re)
        return sorted({m.group(1) for k in self.keys for m in [pat.match(k)] if m})

    def add(self, port: str, up: str, rule: tuple = ID) -> None:
        self.map[port] = (up, rule)

    def lin(self, port: str, up: str) -> None:
        """Linear, norm or BatchNorm affine: ``weight`` and ``bias``."""
        self.add(f"{port}.weight", f"{up}.weight")
        self.add(f"{port}.bias", f"{up}.bias")

    def bn(self, port: str, up: str) -> None:
        self.lin(port, up)
        self.add(f"{port}.running_mean", f"{up}.running_mean")
        self.add(f"{port}.running_var", f"{up}.running_var")

    def conv(self, port: str, up: str, bias: bool = True) -> None:
        """An upstream Conv2d onto the port's ``RingConv`` / ``Conv`` wrapper."""
        if bias:
            self.lin(f"{port}.conv_0", up)
        else:
            self.add(f"{port}.conv_0.weight", f"{up}.weight")

    def tap0(self, port: str, up: str) -> None:
        self.add(f"{port}.weight", f"{up}.weight", TAP0)
        self.add(f"{port}.bias", f"{up}.bias")

    def mid(self, port: str, up: str, k: int) -> None:
        self.add(f"{port}.weight", f"{up}.weight", mid_tap(k))
        if self.has(f"{up}.bias", f"{port}.bias"):
            self.add(f"{port}.bias", f"{up}.bias")


# ------------------------------------------------------------------ families


def efficient_unet(t: _Table, mf: bool = False) -> None:
    """``EfficientUNet`` (JAX ``convert_efficient_unet``); ``mf`` the
    MeanFlow variant: two time-embedding MLPs and timm qk-norm attention."""
    for name in ("start_time_embedding", "end_time_embedding") if mf else ("time_embedding",):
        t.lin(f"{name}.dense_0", f"{name}.1")
        t.lin(f"{name}.dense_1", f"{name}.3")
    t.conv("in_conv", "in_conv")
    t.conv("out_conv", "out_conv")
    for blk in t.ids(r"([du]_block\d)\.", r"([du]_block\d)\."):
        if t.has(f"{blk}.downsample.0.weight", f"{blk}.down_conv.conv_0.weight"):
            t.conv(f"{blk}.down_conv", f"{blk}.downsample.0")
        if t.has(f"{blk}.upsample.1.weight", f"{blk}.up_conv.conv_0.weight"):
            t.conv(f"{blk}.up_conv", f"{blk}.upsample.1")
        for j in t.ids(rf"{blk}\.residual_blocks\.(\d+)\.", rf"{blk}\.res(\d+)\."):
            p, u = f"{blk}.res{j}", f"{blk}.residual_blocks.{j}"
            t.lin(f"{p}.groupnorm_0", f"{u}.norm1")
            t.conv(f"{p}.conv1", f"{u}.conv1")
            t.lin(f"{p}.norm2.dense_0", f"{u}.norm2.proj.1")
            t.conv(f"{p}.conv2", f"{u}.conv2")
            if t.has(f"{u}.skip.weight", f"{p}.skip.conv_0.weight"):
                t.conv(f"{p}.skip", f"{u}.skip")
        if t.has(f"{blk}.self_attn_block.norm.weight", f"{blk}.attn.groupnorm_0.weight"):
            p, u = f"{blk}.attn", f"{blk}.self_attn_block"
            t.lin(f"{p}.groupnorm_0", f"{u}.norm")
            if mf:
                t.lin(f"{p}.qkv", f"{u}.attn.qkv")
                t.add(f"{p}.q_norm_g", f"{u}.attn.q_norm.g")
                t.add(f"{p}.k_norm_g", f"{u}.attn.k_norm.g")
                t.lin(f"{p}.proj", f"{u}.attn.proj")
            else:
                m = f"{p}.multiheaddotproductattention_0"
                for i, name in enumerate(("query", "key", "value")):
                    t.add(f"{m}.{name}.weight", f"{u}.attn.in_proj_weight", rows(i, 3))
                    t.add(f"{m}.{name}.bias", f"{u}.attn.in_proj_bias", rows(i, 3))
                t.lin(f"{m}.out", f"{u}.attn.out_proj")


def _adm_resblock(t: _Table, p: str, u: str) -> None:
    t.lin(f"{p}.in_norm", f"{u}.in_layers.0")
    t.conv(f"{p}.in_conv", f"{u}.in_layers.2")
    t.lin(f"{p}.emb_proj", f"{u}.emb_layers.1")
    t.lin(f"{p}.out_norm", f"{u}.out_layers.0")
    t.conv(f"{p}.out_conv", f"{u}.out_layers.3")
    if t.has(f"{u}.skip_connection.weight", f"{p}.skip.conv_0.weight"):
        t.conv(f"{p}.skip", f"{u}.skip_connection")


def _object_aware_attn(t: _Table, p: str, u: str) -> None:
    """``ObjectAwareCrossAttention``: its 1D convs read as Linears.  An
    upstream ``norm_for_obj_embedding`` is mapped to that name, as the JAX
    converter writes it; the model, as the JAX one, names the module
    ``norm_for_obj_embedding_gn`` (an option no registry config sets), so
    such a checkpoint is refused at the module, as in the JAX package.  No
    GLIDE block is mapped: the JAX converter maps none either."""
    t.lin(f"{p}.norm_for_qkv", f"{u}.norm_for_qkv")
    for name in ("qkv_projector", "layout_content_embedding_projector", "layout_position_embedding_projector",
                 "proj_out"):
        t.tap0(f"{p}.{name}", f"{u}.{name}")
    for name in ("norm_for_obj_class_embedding", "norm_for_layout_positional_embedding",
                 "norm_for_image_patch_positional_embedding"):
        t.lin(f"{p}.{name}", f"{u}.{name}")
    if t.has(f"{u}.norm_for_obj_embedding.weight", f"{p}.norm_for_obj_embedding.weight"):
        t.lin(f"{p}.norm_for_obj_embedding", f"{u}.norm_for_obj_embedding")


def layout_unet(
    t: _Table, channel_mult=(1, 2, 4, 8), num_res_blocks: int = 2, attention_ds=(4, 8),
    num_attention_blocks: int = 1, v0: bool = False,
) -> None:
    """``LayoutUnetV1`` and the v0 ``LayoutUnet`` (JAX
    ``convert_layout_unet``): the reference's input / middle / output block
    lists replayed onto the port's named modules.  V1's time MLP sits at
    ``time_embed.1/3`` (a parameterless sinusoid leads its Sequential), v0's
    at ``time_embed.0/2``; ingestion reads whichever the checkpoint holds,
    export writes the architecture's."""
    one = "time_embed.1.weight" in t.keys if t.ingest else not v0
    t0, t1 = ("time_embed.1", "time_embed.3") if one else ("time_embed.0", "time_embed.2")
    t.lin("time_embed.dense_0", t0)
    t.lin("time_embed.dense_1", t1)
    t.conv("in_conv", "input_blocks.0.0")
    t.lin("out_norm", "out.0")
    t.conv("out_conv", "out.2")
    ds, idx = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _adm_resblock(t, f"in_{level}_{i}_res", f"input_blocks.{idx}.0")
            if ds in attention_ds:
                for a in range(num_attention_blocks):
                    _object_aware_attn(t, f"in_{level}_{i}_attn{a}", f"input_blocks.{idx}.{1 + a}")
            idx += 1
        if level != len(channel_mult) - 1:
            _adm_resblock(t, f"down_{level}", f"input_blocks.{idx}.0")
            idx += 1
            ds *= 2
    _adm_resblock(t, "mid_res1", "middle_block.0")
    _object_aware_attn(t, "mid_attn", "middle_block.1")
    _adm_resblock(t, "mid_res2", "middle_block.2")
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _adm_resblock(t, f"out_{level}_{i}_res", f"output_blocks.{idx}.0")
            off = 1
            if ds in attention_ds:
                for a in range(num_attention_blocks):
                    _object_aware_attn(t, f"out_{level}_{i}_attn{a}", f"output_blocks.{idx}.{off + a}")
                off += num_attention_blocks
            if level and i == num_res_blocks:
                _adm_resblock(t, f"up_{level}", f"output_blocks.{idx}.{off}")
                ds //= 2
            idx += 1


def layout_encoder(t: _Table) -> None:
    """``LayoutTransformerEncoder`` (JAX ``convert_layout_encoder``)."""
    t.lin("transformer_proj", "transformer_proj")
    t.add("obj_class_embedding.weight", "obj_class_embedding.weight")
    t.lin("obj_bbox_embedding", "obj_bbox_embedding")
    t.lin("obj_bbox_2d_embedding", "obj_bbox_2d_embedding")
    if t.has("final_ln.weight", "final_ln.weight"):
        t.lin("final_ln", "final_ln")
    if t.has("positional_embedding", "positional_embedding"):
        t.add("positional_embedding", "positional_embedding")
    n = 0
    while t.has(f"transform.resblocks.{n}.attn.c_qkv.weight", f"resblock{n}.attn.c_qkv.weight"):
        p, u = f"resblock{n}", f"transform.resblocks.{n}"
        t.lin(f"{p}.attn.c_qkv", f"{u}.attn.c_qkv")
        t.lin(f"{p}.attn.c_proj", f"{u}.attn.c_proj")
        t.lin(f"{p}.ln_1", f"{u}.ln_1")
        t.lin(f"{p}.ln_2", f"{u}.ln_2")
        t.lin(f"{p}.mlp_fc", f"{u}.mlp.c_fc")
        t.lin(f"{p}.mlp_proj", f"{u}.mlp.c_proj")
        n += 1


def _res1d(t: _Table, p: str, u: str) -> None:
    t.lin(f"{p}.in_norm", f"{u}.in_layers.0")
    t.mid(f"{p}.in_conv", f"{u}.in_layers.2", 3)
    t.lin(f"{p}.emb_proj", f"{u}.emb_layers.1")
    t.lin(f"{p}.out_norm", f"{u}.out_layers.0")
    t.mid(f"{p}.out_conv", f"{u}.out_layers.3", 3)
    if t.has(f"{u}.skip_connection.weight", f"{p}.skip.weight"):
        t.mid(f"{p}.skip", f"{u}.skip_connection", 1)


def _spatial_transformer_1d(t: _Table, p: str, u: str, depth: int) -> None:
    t.lin(f"{p}.norm", f"{u}.norm")
    t.mid(f"{p}.proj_in", f"{u}.proj_in", 1)
    t.mid(f"{p}.proj_out", f"{u}.proj_out", 1)
    for d in range(depth):
        b, bu = f"{p}.block{d}", f"{u}.transformer_blocks.{d}"
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                t.add(f"{b}.{a}.{name}.weight", f"{bu}.{a}.{name}.weight")
            t.lin(f"{b}.{a}.to_out", f"{bu}.{a}.to_out.0")
        t.lin(f"{b}.ff.geglu", f"{bu}.ff.net.0.proj")
        t.lin(f"{b}.ff.proj_out", f"{bu}.ff.net.2")
        for name in ("norm1", "norm2", "norm3"):
            t.lin(f"{b}.{name}", f"{bu}.{name}")


def _gconv(t: _Table, p: str, u: str) -> None:
    """``GraphTripleConv`` with batch-normalised MLPs: Linear / BatchNorm at
    Sequential indices 0 / 1 and 3 / 4, running statistics included."""
    for net in ("net1", "net2"):
        t.lin(f"{p}.{net}.lin0", f"{u}.{net}.0")
        t.bn(f"{p}.{net}.bn0", f"{u}.{net}.1")
        t.lin(f"{p}.{net}.lin1", f"{u}.{net}.3")
        t.bn(f"{p}.{net}.bn1", f"{u}.{net}.4")
    _gconv_projections(t, p, u)


def _gconv_projections(t: _Table, p: str, u: str) -> None:
    if t.has(f"{u}.linear_projection.weight", f"{p}.linear_projection.weight"):
        t.lin(f"{p}.linear_projection", f"{u}.linear_projection")
        t.lin(f"{p}.linear_projection_pred", f"{u}.linear_projection_pred")


def _gconv_auto(t: _Table, p: str, u: str) -> None:
    """Batch-normalised MLPs, or plain ones (Linears at 0 and 2)."""
    if t.has(f"{u}.net1.1.running_mean", f"{p}.net1.bn0.running_mean"):
        return _gconv(t, p, u)
    for net in ("net1", "net2"):
        t.lin(f"{p}.{net}.lin0", f"{u}.{net}.0")
        t.lin(f"{p}.{net}.lin1", f"{u}.{net}.2")
    _gconv_projections(t, p, u)


def unet_1d(
    t: _Table, channel_mult=(1, 1, 1, 1), num_res_blocks: int = 2, attention_resolutions=(4, 2),
    transformer_depth: int = 1, gcn_layers: int = 5,
) -> None:
    """``UNet1DModel`` (JAX ``convert_unet_1d``): the 1D ADM trunk, its
    single-token transformers and the box GCN."""
    t.lin("time_embed0", "time_embed.0")
    t.lin("time_embed1", "time_embed.2")
    t.mid("in_conv", "input_blocks.0.0", 3)
    t.lin("out_norm", "out.0")
    t.mid("out_conv", "out.2", 3)
    t.add("pred_embeddings.weight", "pred_embeddings.weight")
    t.lin("box_embeddings", "box_embeddings")
    if t.has("box_time_emb.weight", "box_time_emb.weight"):
        t.lin("box_time_emb", "box_time_emb")
    for i in range(gcn_layers):
        _gconv(t, f"box_graph_cov.gconv{i}", f"box_graph_cov.gconvs.{i}")
    ds, idx = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _res1d(t, f"in_{level}_{i}_res", f"input_blocks.{idx}.0")
            if ds in attention_resolutions:
                _spatial_transformer_1d(t, f"in_{level}_{i}_attn", f"input_blocks.{idx}.1", transformer_depth)
            idx += 1
        if level != len(channel_mult) - 1:
            t.mid(f"down_{level}", f"input_blocks.{idx}.0.op", 3)
            idx += 1
            ds *= 2
    _res1d(t, "mid_res1", "middle_block.0")
    _spatial_transformer_1d(t, "mid_attn", "middle_block.1", transformer_depth)
    _res1d(t, "mid_res2", "middle_block.2")
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _res1d(t, f"out_{level}_{i}_res", f"output_blocks.{idx}.0")
            off = 1
            if ds in attention_resolutions:
                _spatial_transformer_1d(t, f"out_{level}_{i}_attn", f"output_blocks.{idx}.{off}", transformer_depth)
                off += 1
            if level and i == num_res_blocks:
                t.mid(f"up_{level}", f"output_blocks.{idx}.{off}.conv", 3)
                ds //= 2
            idx += 1


def point_unet(t: _Table, num_layers: int = 6) -> None:
    """``PointUNet``: six gated PCNet layers (JAX ``convert_point_unet``)."""
    for i in range(num_layers):
        p, u = f"layer{i}", f"layers.{i}"
        t.lin(f"{p}.fea_layer", f"{u}.fea_layer")
        t.add(f"{p}.cond_bias.weight", f"{u}.cond_bias.weight")
        t.lin(f"{p}.cond_gate", f"{u}.cond_gate")


def object_gen_encoder(t: _Table) -> None:
    """``ObjectGenEncoder`` (JAX ``convert_object_gen_encoder``)."""
    t.lin("bbox_proj", "bbox_proj")
    for i in range(3):
        t.lin(f"second{i}", f"second_linear.{2 * i}")


def scene_graph(t: _Table) -> None:
    """``SceneGraph`` (JAX ``convert_scene_graph``); the reference's
    ``obj_embeddings_dc``, which its forward never reads, is skipped."""
    for name in ("obj_embeddings_ec", "pred_embeddings_ec", "pred_embeddings_man_dc"):
        t.add(f"{name}.weight", f"{name}.weight")
    for name in ("gconv_net_ec", "gconv_net_manipulation", "gconv_net_ec_rel_l"):
        i = 0
        while t.has(f"{name}.gconvs.{i}.net1.0.weight", f"{name}.gconv{i}.net1.lin0.weight"):
            _gconv_auto(t, f"{name}.gconv{i}", f"{name}.gconvs.{i}")
            i += 1


def hdit(t: _Table) -> None:
    """HDiT (JAX ``convert_hdit``): RFF + mapping-network time embedding,
    tokenizer / detokenizer, the positional embedding and every
    down / mid / up block; depths counted from the key set."""

    def count(up_re: str, port_re: str) -> int:
        return len(t.ids(up_re, port_re))

    def mapping_network(p: str, u: str, depth: int) -> None:
        t.add(f"{p}.norm_in.weight", f"{u}.0.scale")
        for k in range(depth):
            m = f"{u}.{k + 1}"
            t.add(f"{p}.mlp{k}_norm.weight", f"{m}.norm.scale")
            t.add(f"{p}.mlp{k}_gegelu.dense_0.weight", f"{m}.gegelu.weight")
            t.add(f"{p}.mlp{k}_linear.weight", f"{m}.linear.weight")
        t.add(f"{p}.norm_out.weight", f"{u}.{depth + 1}.scale")

    def block(p: str, u: str) -> None:
        a, f = f"{u}.residual_attn", f"{u}.residual_ffn"
        t.add(f"{p}.attn.norm.proj.weight", f"{a}.norm.proj.0.weight")
        t.add(f"{p}.attn.scale", f"{a}.scale")
        t.add(f"{p}.attn.qkv_proj.weight", f"{a}.qkv_proj.weight")
        t.add(f"{p}.attn.out_proj.weight", f"{a}.out_proj.weight")
        t.add(f"{p}.ffn.adarms.proj.weight", f"{f}.adarms.proj.0.weight")
        t.add(f"{p}.ffn.gegelu.dense_0.weight", f"{f}.gegelu.weight")
        t.add(f"{p}.ffn.linear.weight", f"{f}.linear.weight")

    levels = count(r"down_levels\.level_(\d+)\.", r"down_(\d+)_\d+\.")
    mid_depth = count(r"mid_levels\.(\d+)\.", r"mid_(\d+)\.")
    map_depth = count(r"timestep_pe\.1\.(\d+)\.norm\.scale", r"timestep_mapping\.mlp(\d+)_norm\.")
    t.add("rff_freqs", "timestep_pe.0.freqs")
    t.add("rff_linear.weight", "timestep_pe.0.linear.weight")
    mapping_network("timestep_mapping", "timestep_pe.1", map_depth)
    t.add("tokenizer.weight", "tokenizer.0.weight")
    t.add("detok_norm.weight", "detokenizer.0.scale")
    t.add("detok_linear.weight", "detokenizer.1.weight")
    if t.has("spatial_pe.embedding", "spatial_pe"):
        t.add("spatial_pe", "spatial_pe.embedding")
    else:  # an absolute positional embedding and its mapping network
        t.add("ape_linear.weight", "spatial_pe.0.linear.weight")
        sp_depth = count(r"spatial_pe\.1\.(\d+)\.norm\.scale", r"spatial_mapping\.mlp(\d+)_norm\.")
        mapping_network("spatial_mapping", "spatial_pe.1", sp_depth)
    for i in range(levels):
        for j in range(count(rf"down_levels\.level_{i}\.(\d+)\.", rf"down_{i}_(\d+)\.")):
            block(f"down_{i}_{j}", f"down_levels.level_{i}.{j}")
            block(f"up_{i}_{j}", f"up_levels.level_{i}.{j}")
        t.add(f"merge_{i}.weight", f"down_levels.merge_{i}.1.weight")
        t.add(f"expand_{i}_linear.weight", f"up_levels.expand_{i}.linear.weight")
        t.add(f"expand_{i}_alpha", f"up_levels.expand_{i}.alpha")
    for j in range(mid_depth):
        block(f"mid_{j}", f"mid_levels.{j}")


def _glide_attn(t: _Table, p: str, u: str) -> None:
    """GLIDE's ``AttentionBlock``: its norm and two 1D convs read as Linears."""
    t.lin(f"{p}.norm", f"{u}.norm")
    t.tap0(f"{p}.qkv", f"{u}.qkv")
    t.tap0(f"{p}.proj_out", f"{u}.proj_out")


def _spatial_transformer(t: _Table, p: str, u: str, depth: int) -> None:
    """LDM's ``SpatialTransformer`` with Linear in / out projections (the
    JAX ``_spatial_transformer``: a bias where the checkpoint holds one)."""
    t.lin(f"{p}.norm", f"{u}.norm")
    for name in ("proj_in", "proj_out"):
        t.add(f"{p}.{name}.weight", f"{u}.{name}.weight")
        if t.has(f"{u}.{name}.bias", f"{p}.{name}.bias"):
            t.add(f"{p}.{name}.bias", f"{u}.{name}.bias")
    for d in range(depth):
        b, bu = f"{p}.block{d}", f"{u}.transformer_blocks.{d}"
        for name in ("norm1", "norm2", "norm3"):
            t.lin(f"{b}.{name}", f"{bu}.{name}")
        for a in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v"):
                t.add(f"{b}.{a}.{name}.weight", f"{bu}.{a}.{name}.weight")
            t.lin(f"{b}.{a}.to_out", f"{bu}.{a}.to_out.0")
        t.lin(f"{b}.ff_geglu.proj", f"{bu}.ff.net.0.proj")
        t.lin(f"{b}.ff_out", f"{bu}.ff.net.2")


def openai_unet(
    t: _Table, channel_mult=(1, 2, 4, 8), num_res_blocks: int = 2, attention_resolutions=(4, 8),
    resblock_updown: bool = False, use_spatial_transformer: bool = False, transformer_depth: int = 1,
) -> None:
    """The vendored guided-diffusion ``OpenAIUNetModel`` (JAX
    ``convert_openai_unet``): its input / middle / output block lists
    replayed onto the port's named modules; GLIDE attention blocks or
    SpatialTransformers at the attention resolutions; a conv ``Downsample``
    / ``Upsample`` where the checkpoint holds one."""

    def attn(p: str, u: str) -> None:
        if use_spatial_transformer:
            _spatial_transformer(t, p, u, transformer_depth)
        else:
            _glide_attn(t, p, u)

    t.lin("time_dense1", "time_embed.0")
    t.lin("time_dense2", "time_embed.2")
    t.conv("in_conv", "input_blocks.0.0")
    t.lin("out_norm", "out.0")
    t.conv("out_conv", "out.2")
    if t.has("label_emb.weight", "label_emb.weight"):
        t.add("label_emb.weight", "label_emb.weight")
    ds, idx = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _adm_resblock(t, f"in_{level}_{i}_res", f"input_blocks.{idx}.0")
            if ds in attention_resolutions:
                attn(f"in_{level}_{i}_attn", f"input_blocks.{idx}.1")
            idx += 1
        if level != len(channel_mult) - 1:
            if resblock_updown:
                _adm_resblock(t, f"in_{level}_down", f"input_blocks.{idx}.0")
            elif t.has(f"input_blocks.{idx}.0.op.weight", f"in_{level}_down.op.conv_0.weight"):
                t.conv(f"in_{level}_down.op", f"input_blocks.{idx}.0.op")
            idx += 1
            ds *= 2
    _adm_resblock(t, "mid_res1", "middle_block.0")
    attn("mid_attn", "middle_block.1")
    _adm_resblock(t, "mid_res2", "middle_block.2")
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _adm_resblock(t, f"out_{level}_{i}_res", f"output_blocks.{idx}.0")
            off = 1
            if ds in attention_resolutions:
                attn(f"out_{level}_{i}_attn", f"output_blocks.{idx}.{off}")
                off += 1
            if level and i == num_res_blocks:
                if resblock_updown:
                    _adm_resblock(t, f"out_{level}_up", f"output_blocks.{idx}.{off}")
                elif t.has(f"output_blocks.{idx}.{off}.conv.weight", f"out_{level}_up.conv.conv_0.weight"):
                    t.conv(f"out_{level}_up.conv", f"output_blocks.{idx}.{off}.conv")
                ds //= 2
            idx += 1


def refinenet(t: _Table) -> None:
    """``LiDARGenRefineNet`` (JAX ``convert_refinenet``).  A residual block
    that pools (the first of level 2: down-sampling at dilation 1) holds its
    ``conv2`` and ``skip`` as ``Sequential(conv, avgpool)`` upstream, keys
    ``.0``; ingestion reads whichever form the checkpoint holds."""

    def inorm(p: str, u: str) -> None:
        t.add(f"{p}.alpha", f"{u}.alpha", flat(0))
        t.add(f"{p}.post_weight", f"{u}.post_affine.weight", flat(3))
        t.add(f"{p}.post_bias", f"{u}.post_affine.bias")

    def resblock(p: str, u: str) -> None:
        pooled = f"{u}.conv2.0.weight" in t.keys if t.ingest else p == "d2a"
        inorm(f"{p}.norm1", f"{u}.norm1")
        t.conv(f"{p}.conv1", f"{u}.conv1")
        inorm(f"{p}.norm2", f"{u}.norm2")
        t.conv(f"{p}.conv2", f"{u}.conv2.0" if pooled else f"{u}.conv2")
        skips = (f"{u}.skip.0", f"{u}.skip") if t.ingest else ((f"{u}.skip.0",) if pooled else (f"{u}.skip",))
        for sk in skips:
            if t.has(f"{sk}.weight", f"{p}.skip.conv_0.weight"):
                t.conv(f"{p}.skip", sk)
                break

    def rcu(p: str, u: str, num_blocks: int = 2, num_stages: int = 2) -> None:
        for b in range(num_blocks):
            for s in range(num_stages):
                t.conv(f"{p}.b{b}s{s}", f"{u}.units.{b}.{2 * s + 1}", bias=False)

    def refineblock(p: str, u: str, num_inputs: int, num_end_blocks: int = 1) -> None:
        for i in range(num_inputs):
            rcu(f"{p}.rcu{i}", f"{u}.adaptive_convs.{i}.0")
            if num_inputs > 1:
                t.conv(f"{p}.adapt{i}", f"{u}.adaptive_convs.{i}.1")
        for s in range(2):
            t.conv(f"{p}.crp.crp{s}", f"{u}.crp.convs.{s}.1", bias=False)
        rcu(f"{p}.out_rcu", f"{u}.output_conv", num_blocks=num_end_blocks)

    t.lin("in_conv", "in_conv")
    inorm("out_norm", "out_conv.0")
    t.lin("out_conv", "out_conv.2")
    for d in (1, 2, 3, 4):
        resblock(f"d{d}a", f"d_block{d}.0")
        resblock(f"d{d}b", f"d_block{d}.1")
    refineblock("u4", "u_block4", 1)
    refineblock("u3", "u_block3", 2)
    refineblock("u2", "u_block2", 2)
    refineblock("u1", "u_block1", 2, num_end_blocks=3)


def clip_text(t: _Table) -> None:
    """OpenAI CLIP's text tower (JAX ``convert_clip_text``): the fused
    ``in_proj`` stays fused, ``text_projection`` is used as stored."""
    t.add("token_embedding.weight", "token_embedding.weight")
    t.add("positional_embedding", "positional_embedding")
    t.lin("ln_final", "ln_final")
    t.add("text_projection", "text_projection")
    i = 0
    while t.has(f"transformer.resblocks.{i}.ln_1.weight", f"resblock{i}.ln_1.weight"):
        p, u = f"resblock{i}", f"transformer.resblocks.{i}"
        t.lin(f"{p}.ln_1", f"{u}.ln_1")
        t.add(f"{p}.attn_in_proj.weight", f"{u}.attn.in_proj_weight")
        t.add(f"{p}.attn_in_proj.bias", f"{u}.attn.in_proj_bias")
        t.lin(f"{p}.attn_out_proj", f"{u}.attn.out_proj")
        t.lin(f"{p}.ln_2", f"{u}.ln_2")
        t.lin(f"{p}.mlp_c_fc", f"{u}.mlp.c_fc")
        t.lin(f"{p}.mlp_c_proj", f"{u}.mlp.c_proj")
        i += 1


# --------------------------------------------------------------- the engine


def model_family(cfg) -> Callable[[_Table], None]:
    """The table function of ``cfg.model`` (the JAX
    ``ingest_checkpoint_for_config`` dispatch)."""
    arch = cfg.model.architecture
    mp = dict(cfg.model.params)
    if arch in ("efficient_unet", "efficient_unet_cond", "mf_efficient_unet"):
        return functools.partial(efficient_unet, mf=arch == "mf_efficient_unet")
    if arch == "hdit":
        return hdit
    if arch in ("layout_unet", "layout_unet_v1"):
        return functools.partial(
            layout_unet, channel_mult=tuple(mp.get("channel_mult", (1, 2, 4, 8))),
            num_res_blocks=mp.get("num_res_blocks", 2), attention_ds=tuple(mp.get("attention_ds", (4, 8))),
            num_attention_blocks=mp.get("num_attention_blocks", 1), v0=arch == "layout_unet",
        )
    if arch == "unet_1d":
        return functools.partial(
            unet_1d, channel_mult=tuple(mp.get("channel_mult", (1, 1, 1, 1))),
            num_res_blocks=mp.get("num_res_blocks", 2),
            attention_resolutions=tuple(mp.get("attention_resolutions", (4, 2))),
            transformer_depth=mp.get("transformer_depth", 1),
        )
    if arch == "point_unet":
        return point_unet
    raise ValueError(f"no ingestion for model architecture {arch!r}")


def cond_family(cfg) -> Callable[[_Table], None]:
    """The table function of ``cfg.condition_model``."""
    carch = cfg.condition_model.architecture
    if carch == "layout_encoder_v5":
        raise ValueError(
            "no ingestion for condition model 'layout_encoder_v5' (nuscenes-box-layout-v5): the JAX package's "
            "convert_layout_encoder reads only the base encoder's keys, and the v5 encoder's ObjectGenEncoder "
            "box embedding (obj_bbox_3d_embedding) has no upstream mapping there"
        )
    if carch.startswith("layout_encoder"):
        return layout_encoder
    if carch == "scene_graph":
        return scene_graph
    if carch == "object_gen_encoder":
        return object_gen_encoder
    raise ValueError(f"no ingestion for condition model {carch!r}")


PREFIXES = {"model": "model.", "cond": "condition_model."}  # port module → engine state-dict prefix


def strip_prefix(state_dict: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _strip_ema(sd: Mapping) -> Mapping:
    return strip_prefix(sd, "ema_model.") if any(k.startswith("ema_model.") for k in sd) else sd


def _model_prefix(sd: Mapping) -> str:
    return PREFIXES["model"] if any(k.startswith(PREFIXES["model"]) for k in sd) else ""


def load_torch_checkpoint(path, use_ema: bool = True) -> tuple[dict, dict]:
    """A reference ``.pth`` → (its ``ema_weights``, or ``weights`` without
    EMA weights or with ``use_ema=False``; its ``cfg``).  The file is
    unpickled in full (its ``cfg`` may be any object), so load only
    checkpoints from a trusted source.  A zip-format file is memory-mapped,
    so only the chosen weights' storages are read."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    except RuntimeError:  # the legacy (non-zip) format cannot be mapped
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    key = "ema_weights" if (use_ema and "ema_weights" in ckpt) else "weights"
    return dict(ckpt[key]), ckpt.get("cfg", {})


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _read(rule: tuple, x: torch.Tensor) -> torch.Tensor:
    kind = rule[0]
    if kind == "rows":
        i, n = rule[1:]
        r = x.shape[0] // n
        return x[i * r:(i + 1) * r]
    if kind == "tap0":
        return x[..., 0]
    if kind == "mid_tap":
        return x[..., x.shape[-1] // 2]
    if kind == "flat":
        return x.reshape(-1)
    return x


def convert(build: Callable[[_Table], None], sd: Mapping, expected: Mapping[str, torch.Tensor], what: str,
            read: set | None = None) -> dict[str, torch.Tensor]:
    """Fill the ``state_dict`` of a module whose tensors are ``expected``
    (name → tensor, any device, ``meta`` included) from the upstream state
    dict ``sd`` through the table ``build`` makes; strict (see the module
    docstring).  A tensor that needs no reshaping or cast keeps the
    upstream tensor's memory.  The upstream keys it reads are added to
    ``read``."""
    table = _Table(upstream=sd)
    build(table)
    out: dict[str, torch.Tensor] = {}
    extra = []
    for port, (up, rule) in table.map.items():
        if up not in sd:
            raise KeyError(f"{what}: upstream key {up!r} (for {port!r}) is not in the checkpoint")
        if port not in expected:
            extra.append(f"{up} → {port}")
            continue
        value = _read(rule, _as_tensor(sd[up]))
        want = expected[port]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"{what}: {up} → {port}: shape {tuple(value.shape)} != {tuple(want.shape)}")
        out[port] = value.to(dtype=want.dtype).contiguous()
    missing = sorted(set(expected) - set(out))
    if extra or missing:
        raise KeyError(f"{what}: upstream and port disagree: mapped to no port key {extra}, "
                       f"port keys nothing filled {missing}")
    if read is not None:
        read.update(up for up, _ in table.map.values())
    return out


def export(build: Callable[[_Table], None], state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A port ``state_dict`` → the upstream names, the table run backwards:
    row blocks concatenated, a tap-0 Linear given its kernel axis, a
    middle-tap Linear given ``k`` taps with ``-w`` off the middle (so a
    converter that read another tap would not pass).  Identity leaves are
    the module's own tensors, detached, not copies."""
    table = _Table(port=state)
    build(table)
    out: dict[str, torch.Tensor] = {}
    pieces: dict[str, dict[int, torch.Tensor]] = {}
    for port, (up, rule) in table.map.items():
        x = state[port].detach()
        kind = rule[0]
        if kind == "rows":
            pieces.setdefault(up, {})[rule[1]] = x
        elif kind == "tap0":
            out[up] = x[..., None]
        elif kind == "mid_tap":
            k = rule[1]
            out[up] = torch.stack([x if j == k // 2 else -x for j in range(k)], dim=-1)
        elif kind == "flat":
            out[up] = x.reshape(-1, *(1,) * rule[1])
        else:
            out[up] = x
    for up, parts in pieces.items():
        out[up] = torch.cat([parts[i] for i in range(len(parts))])
    return {k: v.contiguous() for k, v in out.items()}


def build_modules(cfg, device: str | torch.device = "cpu") -> dict[str, nn.Module]:
    """The config's modules, ``{'model'}`` or ``{'model', 'cond'}``, as its
    generator and trainer build them (on ``meta`` they hold no memory)."""
    from ..training.factory import (
        build_diffusion_training, build_flow_training, build_layout_training, build_object_training,
    )

    arch = cfg.model.architecture
    build = {"unet_1d": build_layout_training, "point_unet": build_object_training,
             "mf_efficient_unet": build_flow_training}.get(arch, build_diffusion_training)
    with torch.device(device):
        models = build(cfg, device)[0]
    return models if isinstance(models, dict) else {"model": models}


def _families(cfg) -> dict[str, Callable[[_Table], None]]:
    fams = {"model": model_family(cfg)}
    if getattr(cfg, "condition_model", None) is not None:
        fams["cond"] = cond_family(cfg)
    return fams


def ingest_engine_state_dict(cfg, sd: Mapping, modules: dict[str, nn.Module] | None = None,
                             skipped: list | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """An engine state dict (``model.`` / ``condition_model.`` /
    ``ema_model.`` forms) → the port ``state_dict`` of each of ``cfg``'s
    modules, ``{'model': ...}`` or ``{'model': ..., 'cond': ...}``, held to
    ``modules`` (default: the config's modules built on ``meta``).  The
    engine keys that no converter reads are appended to ``skipped``."""
    fams = _families(cfg)
    sd = _strip_ema(sd)
    prefixes = {"model": _model_prefix(sd), "cond": PREFIXES["cond"]}
    subs = {k: strip_prefix(sd, prefixes[k]) for k in fams}
    if "cond" in fams and not subs["cond"]:
        raise KeyError(f"the checkpoint holds no condition_model.* weights for {cfg.condition_model.architecture!r}")
    modules = modules or build_modules(cfg, "meta")
    out, read = {}, set()
    for k, fam in fams.items():
        arch = cfg.model.architecture if k == "model" else cfg.condition_model.architecture
        keys: set = set()
        out[k] = convert(fam, subs[k], modules[k].state_dict(), f"{k} ({arch})", keys)
        read.update(prefixes[k] + n for n in keys)
    if skipped is not None:
        skipped.extend(k for k in sd if k not in read)
    return out


def ingest_checkpoint_for_config(cfg, path, use_ema: bool = True, modules: dict[str, nn.Module] | None = None,
                                 skipped: list | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """One call from a reference ``.pth`` to the port ``state_dict`` of each
    of ``cfg``'s modules (EMA weights preferred, as the reference's
    ``inference.py`` loads them); see :func:`ingest_engine_state_dict`."""
    sd, _ = load_torch_checkpoint(path, use_ema)
    return ingest_engine_state_dict(cfg, sd, modules, skipped)


def to_upstream_checkpoint(cfg, models: Mapping[str, nn.Module], ema_models: Mapping[str, nn.Module] | None = None,
                           extra: Mapping[str, torch.Tensor] | None = None) -> dict:
    """An upstream-format engine checkpoint ``{'weights', 'ema_weights',
    'cfg'}`` from port modules (``ema_models`` default: ``models``):
    ``model.`` / ``condition_model.`` names through the inverse tables, plus
    ``extra`` upstream keys in both (keys the converters skip)."""
    from ..training.checkpoint import config_to_dict

    fams = _families(cfg)

    def engine(mods):
        out = {}
        for k, fam in fams.items():
            out.update({PREFIXES[k] + n: v for n, v in export(fam, mods[k].state_dict()).items()})
        out.update({k: v.clone() for k, v in (extra or {}).items()})
        return out

    return {"weights": engine(models), "ema_weights": engine(ema_models or models), "cfg": config_to_dict(cfg)}


def convert_openai_unet(sd: Mapping, module: nn.Module, **arch) -> dict[str, torch.Tensor]:
    """A vendored ``OpenAIUNetModel`` state dict → the ``state_dict`` of
    the port's :class:`~lidarcrafter_tpu_torch.models.openai_unet.OpenAIUNet`
    ``module`` (strict).  ``arch`` takes :func:`openai_unet`'s block-list
    options (``channel_mult``, ``num_res_blocks``, ``attention_resolutions``,
    ``resblock_updown``, ``use_spatial_transformer``, ``transformer_depth``),
    as the module was built.  A family converter, as in the JAX package: no
    config of the registry builds this model, so
    :func:`ingest_checkpoint_for_config` has no route to it."""
    return convert(functools.partial(openai_unet, **arch), sd, module.state_dict(), "openai_unet")


def convert_refinenet(sd: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """A ``LiDARGenRefineNet`` state dict → the ``state_dict`` of the
    port's :class:`~lidarcrafter_tpu_torch.models.refinenet.LiDARGenRefineNet`
    ``module`` (strict); a family converter, as :func:`convert_openai_unet`."""
    return convert(refinenet, sd, module.state_dict(), "refinenet")


def convert_clip_text(sd: Mapping, module: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict (full model or text tower; ``visual.*`` and
    the rest skipped) → the ``state_dict`` of
    :class:`~lidarcrafter_tpu_torch.models.clip_text.CLIPTextEncoder`,
    held to ``module`` (default: the tower whose dimensions ``sd`` gives,
    on ``meta``)."""
    if module is None:
        from ..models.clip_text import CLIPTextEncoder

        with torch.device("meta"):
            module = CLIPTextEncoder(**CLIPTextEncoder.dims_of(sd))
    return convert(clip_text, sd, module.state_dict(), "clip text tower")
