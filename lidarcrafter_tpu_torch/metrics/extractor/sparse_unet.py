"""Sparse 3D UNet feature extractors: MinkowskiNet (FSVD) and SPVCNN (FPVD).

Port of the JAX package's ``metrics/extractor/sparse_unet.py``, upstream's
torchsparse eval backbones on the voxel table of ``ops/sparse.py``.
Inference only: the BatchNorms run on their running statistics and the
dropouts are left out.  The submodules carry the flax names, so the JAX
parameter tree loads through ``weights.load_flax_params``; a sparse conv's
kernel is the parameter ``kernel``, (taps, Cin, Cout) in ij-meshgrid order.
:func:`convert_torchsparse_state_dict` reads upstream's torchsparse v1.4
``model.ckpt`` state dict, and :func:`to_torchsparse_state_dict` writes one.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sparse import (
    point_to_voxel_mean,
    sparse_downsample2,
    sparse_upsample2,
    submanifold_conv3d,
    voxel_to_point_trilinear,
    voxelize,
    voxelize_mean,
)
from .pointnet import FrozenBN

# torchsparse layer_num; at cr 0.5 the 16 depth shells of the last 48
# features make the upstream eval descriptor of 768
DEFAULT_LAYERS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


class SubMConv3(nn.Module):
    """3³ submanifold sparse conv (torchsparse Conv3d ks=3 s=1, no bias)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(27, in_ch, out_ch))

    def forward(self, feats, coords, mask):
        return submanifold_conv3d(feats, coords, mask, self.kernel)


class SparseConvBlock(nn.Module):
    """Downsampling block: 2³ stride-2 conv + BN + ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, in_ch, out_ch))
        self.frozenbn_0 = FrozenBN(out_ch)

    def forward(self, feats, coords, mask):
        out, oc, om = sparse_downsample2(feats, coords, mask, self.kernel, max_voxels=feats.shape[0])
        return torch.where(om[:, None], F.relu(self.frozenbn_0(out)), 0.0), oc, om


class SparseDeconvBlock(nn.Module):
    """Upsampling block: 2³ stride-2 transposed conv + BN + ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, in_ch, out_ch))
        self.frozenbn_0 = FrozenBN(out_ch)

    def forward(self, feats, coords, mask, fine_coords, fine_mask):
        out = sparse_upsample2(feats, coords, mask, fine_coords, fine_mask, self.kernel)
        return torch.where(fine_mask[:, None], F.relu(self.frozenbn_0(out)), 0.0)


class SparseResBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN plus a shortcut (1×1 conv + BN when the width
    changes), then ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.submconv3_0 = SubMConv3(in_ch, out_ch)
        self.frozenbn_0 = FrozenBN(out_ch)
        self.submconv3_1 = SubMConv3(out_ch, out_ch)
        self.frozenbn_1 = FrozenBN(out_ch)
        if in_ch != out_ch:
            self.dense_0 = nn.Linear(in_ch, out_ch, bias=False)
            self.frozenbn_2 = FrozenBN(out_ch)

    def forward(self, feats, coords, mask):
        h = F.relu(self.frozenbn_0(self.submconv3_0(feats, coords, mask)))
        h = self.frozenbn_1(self.submconv3_1(h, coords, mask))
        sc = self.frozenbn_2(self.dense_0(feats)) if hasattr(self, "dense_0") else feats
        return torch.where(mask[:, None], F.relu(h + sc), 0.0)


class _SparseUNetBase(nn.Module):
    """The stem, 4 down stages and 4 up stages both backbones share."""

    def __init__(self, layer_num: Sequence[int] = DEFAULT_LAYERS, cr: float = 0.5, input_dims: int = 4,
                 num_classes: int = 17, voxel_size: float = 0.05, max_voxels: int = 32768):
        super().__init__()
        self.voxel_size, self.max_voxels, self.num_classes = voxel_size, max_voxels, num_classes
        cs = self.cs = [int(cr * x) for x in layer_num]
        self.stem_conv1 = SubMConv3(input_dims, cs[0])
        self.stem_bn1 = FrozenBN(cs[0])
        self.stem_conv2 = SubMConv3(cs[0], cs[0])
        self.stem_bn2 = FrozenBN(cs[0])
        for k in range(1, 5):
            setattr(self, f"down{k}", SparseConvBlock(cs[k - 1], cs[k - 1]))
            setattr(self, f"stage{k}_res1", SparseResBlock(cs[k - 1], cs[k]))
            setattr(self, f"stage{k}_res2", SparseResBlock(cs[k], cs[k]))
        skips = [cs[3], cs[2], cs[1], cs[0]]
        prev = cs[4]
        for j in range(1, 5):
            setattr(self, f"up{j}_deconv", SparseDeconvBlock(prev, cs[4 + j]))
            setattr(self, f"up{j}_res1", SparseResBlock(cs[4 + j] + skips[j - 1], cs[4 + j]))
            setattr(self, f"up{j}_res2", SparseResBlock(cs[4 + j], cs[4 + j]))
            prev = cs[4 + j]

    def stem(self, feats, coords, mask):
        f = F.relu(self.stem_bn1(self.stem_conv1(feats, coords, mask)))
        f = F.relu(self.stem_bn2(self.stem_conv2(f, coords, mask)))
        return torch.where(mask[:, None], f, 0.0)

    def encoder(self, f0, c0, m0):
        """Each stage: down, then 2 residual blocks; every level's (f, c, m)."""
        levels = [(f0, c0, m0)]
        f, c, m = f0, c0, m0
        for k in range(1, 5):
            f, c, m = getattr(self, f"down{k}")(f, c, m)
            f = getattr(self, f"stage{k}_res1")(f, c, m)
            f = getattr(self, f"stage{k}_res2")(f, c, m)
            levels.append((f, c, m))
        return levels

    def decoder_step(self, j, f, c, m, skip):
        """Up-j: deconv onto the skip's sites, concat, 2 residual blocks."""
        sf, sc, sm = skip
        up = getattr(self, f"up{j}_deconv")(f, c, m, sc, sm)
        h = torch.cat([up, sf], dim=-1)
        h = getattr(self, f"up{j}_res1")(h, sc, sm)
        h = getattr(self, f"up{j}_res2")(h, sc, sm)
        return h, sc, sm


class MinkowskiNet(_SparseUNetBase):
    """The voxel extractor behind FSVD.  ``forward(points, feats,
    point_mask)`` voxelizes (first point wins) and returns ``logits`` (V,
    cs[8]) per-voxel features, ``output`` the class head, ``coords`` /
    ``mask`` of level 0 and the ``bottleneck`` level."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.classifier = nn.Linear(self.cs[8], self.num_classes)

    def forward(self, points, feats, point_mask):
        coords, src, vmask, _ = voxelize(points, self.voxel_size, point_mask=point_mask, max_voxels=self.max_voxels)
        vfeats = torch.where(vmask[:, None], feats[src.long()], 0.0)
        levels = self.encoder(self.stem(vfeats, coords, vmask), coords, vmask)
        f, c, m = levels[4]
        bottleneck = f
        for j in range(1, 5):
            f, c, m = self.decoder_step(j, f, c, m, levels[4 - j])
        out = self.classifier(f)
        return {"logits": f, "output": torch.where(m[:, None], out, 0.0), "coords": c, "mask": m,
                "bottleneck": bottleneck, "bottleneck_coords": levels[4][1], "bottleneck_mask": levels[4][2]}


class SPVCNN(_SparseUNetBase):
    """The point-voxel extractor behind FPVD: the sparse UNet with a point
    branch (trilinear devoxelisation after the stem, the bottleneck, the
    second up stage and the end, per-point MLPs, mean re-voxelisation before
    each conv stage).  Returns per-point features."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cs = self.cs
        self.pt0_dense, self.pt0_bn = nn.Linear(cs[0], cs[4]), FrozenBN(cs[4])
        self.pt1_dense, self.pt1_bn = nn.Linear(cs[4], cs[6]), FrozenBN(cs[6])
        self.pt2_dense, self.pt2_bn = nn.Linear(cs[6], cs[8]), FrozenBN(cs[8])
        self.classifier = nn.Linear(cs[8], self.num_classes)

    def forward(self, points, feats, point_mask):
        pm = point_mask[:, None]
        vf, vc, vm, pts_vox, _ = voxelize_mean(points, feats, self.voxel_size, point_mask=point_mask,
                                               max_voxels=self.max_voxels)
        x0 = self.stem(vf, vc, vm)
        z0 = voxel_to_point_trilinear(x0, vc, vm, pts_vox, point_mask, level=0)
        levels = self.encoder(point_to_voxel_mean(z0, pts_vox, point_mask, vc, vm, level=0), vc, vm)
        f4, c4, m4 = levels[4]

        z1 = voxel_to_point_trilinear(f4, c4, m4, pts_vox, point_mask, level=4)
        z1 = z1 + F.relu(self.pt0_bn(self.pt0_dense(z0))) * pm
        f = point_to_voxel_mean(z1, pts_vox, point_mask, c4, m4, level=4)
        f, c, m = self.decoder_step(1, f, c4, m4, levels[3])
        f, c, m = self.decoder_step(2, f, c, m, levels[2])

        z2 = voxel_to_point_trilinear(f, c, m, pts_vox, point_mask, level=2)
        z2 = z2 + F.relu(self.pt1_bn(self.pt1_dense(z1))) * pm
        f = point_to_voxel_mean(z2, pts_vox, point_mask, c, m, level=2)
        f, c, m = self.decoder_step(3, f, c, m, levels[1])
        # up4's skip is the stem's output, not the re-voxelised point features
        f, c, m = self.decoder_step(4, f, c, m, (x0, vc, vm))

        z3 = voxel_to_point_trilinear(f, c, m, pts_vox, point_mask, level=0)
        z3 = z3 + F.relu(self.pt2_bn(self.pt2_dense(z2))) * pm
        out = self.classifier(z3)
        return {"logits": torch.where(pm, z3, 0.0), "output": torch.where(pm, out, 0.0), "coords": pts_vox,
                "mask": point_mask}


# ------------------------------------------------------------ upstream weights


def _tap_perm(k: int) -> np.ndarray:
    """torchsparse v1.4 tap order → ours (ij meshgrid, z fastest):
    ``ours[i] = torch[perm[i]]``.  Odd kernels enumerate x fastest there
    (MinkowskiEngine's layout); even kernels are z fastest, as ours."""
    if k % 2 == 0:
        return np.arange(k**3)
    return np.asarray([(z * k + y) * k + x for x in range(k) for y in range(k) for z in range(k)])


def _block_names(present) -> list[tuple[str, str, str]]:
    """(port prefix, upstream prefix, kind) of every block of a backbone;
    ``present(port, upstream)`` says whether an optional block (a
    shortcut, a point transform) is there."""
    out = [("stem_conv1", "stem.0", "conv3"), ("stem_bn1", "stem.1", "bn"),
           ("stem_conv2", "stem.3", "conv3"), ("stem_bn2", "stem.4", "bn"), ("classifier", "classifier.0", "linear")]

    def res(port, up):
        out.extend([(f"{port}.submconv3_0", f"{up}.net.0", "conv3"), (f"{port}.frozenbn_0", f"{up}.net.1", "bn"),
                    (f"{port}.submconv3_1", f"{up}.net.3", "conv3"), (f"{port}.frozenbn_1", f"{up}.net.4", "bn")])
        if present(f"{port}.dense_0", f"{up}.downsample.0"):
            out.extend([(f"{port}.dense_0", f"{up}.downsample.0", "conv1"),
                        (f"{port}.frozenbn_2", f"{up}.downsample.1", "bn")])

    for k in range(1, 5):
        out.extend([(f"down{k}", f"stage{k}.0.net.0", "conv2"), (f"down{k}.frozenbn_0", f"stage{k}.0.net.1", "bn")])
        res(f"stage{k}_res1", f"stage{k}.1")
        res(f"stage{k}_res2", f"stage{k}.2")
    for j in range(1, 5):
        out.extend([(f"up{j}_deconv", f"up{j}.0.net.0", "conv2"), (f"up{j}_deconv.frozenbn_0", f"up{j}.0.net.1", "bn")])
        res(f"up{j}_res1", f"up{j}.1.0")
        res(f"up{j}_res2", f"up{j}.1.1")
    for i in range(3):
        if present(f"pt{i}_dense", f"point_transforms.{i}.0"):
            out.extend([(f"pt{i}_dense", f"point_transforms.{i}.0", "linear"),
                        (f"pt{i}_bn", f"point_transforms.{i}.1", "bn")])
    return out


_BN = ("weight", "bias", "running_mean", "running_var")


def convert_torchsparse_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """Upstream's torchsparse v1.4 MinkowskiNet / SPVCNN ``state_dict`` →
    the port's state dict (what the JAX ``convert_torchsparse_state_dict``
    reads, tap for tap): 3³ kernels reordered (:func:`_tap_perm`), 2³
    kernels as they are, 1×1 convs (Cin, Cout) → Linear weights."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    p3 = torch.as_tensor(_tap_perm(3))
    out = {}
    for port, up, kind in _block_names(lambda port, up: f"{up}.weight" in sd):
        if kind == "bn":
            for a in _BN:
                out[f"{port}.{a}"] = sd[f"{up}.{a}"]
        elif kind == "conv3":
            out[f"{port}.kernel"] = sd[f"{up}.weight"][p3]
        elif kind == "conv2":
            out[f"{port}.kernel"] = sd[f"{up}.weight"]
        elif kind == "conv1":
            out[f"{port}.weight"] = sd[f"{up}.weight"].T
        else:
            out[f"{port}.weight"], out[f"{port}.bias"] = sd[f"{up}.weight"], sd[f"{up}.bias"]
    return {k: v.contiguous() for k, v in out.items()}


def to_torchsparse_state_dict(state: Mapping) -> dict[str, torch.Tensor]:
    """The inverse of :func:`convert_torchsparse_state_dict`: the port's
    state dict under upstream's names and layouts (a ``model.ckpt`` state
    dict)."""
    inv3 = torch.as_tensor(np.argsort(_tap_perm(3)))
    out = {}
    for port, up, kind in _block_names(lambda port, up: f"{port}.weight" in state):
        if kind == "bn":
            for a in _BN:
                out[f"{up}.{a}"] = state[f"{port}.{a}"]
        elif kind == "conv3":
            out[f"{up}.weight"] = state[f"{port}.kernel"][inv3]
        elif kind == "conv2":
            out[f"{up}.weight"] = state[f"{port}.kernel"]
        elif kind == "conv1":
            out[f"{up}.weight"] = state[f"{port}.weight"].T
        else:
            out[f"{up}.weight"], out[f"{up}.bias"] = state[f"{port}.weight"], state[f"{port}.bias"]
    return {k: v.detach().cpu().contiguous().clone() for k, v in out.items()}


def backbone_from_state_dict(sd: Mapping, name: str, voxel_size: float, max_voxels: int) -> _SparseUNetBase:
    """A MinkowskiNet (``name`` 'minkowskinet') or SPVCNN ('spvcnn') with
    the widths, input dims and classes that upstream's state dict ``sd``
    holds, loaded with it, in eval mode on the CPU."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    cs = [sd["stem.0.weight"].shape[2]]
    cs += [sd[f"stage{k}.1.net.0.weight"].shape[2] for k in range(1, 5)]
    cs += [sd[f"up{j}.0.net.0.weight"].shape[2] for j in range(1, 5)]
    cls = MinkowskiNet if name == "minkowskinet" else SPVCNN
    model = cls(layer_num=tuple(cs), cr=1.0, input_dims=sd["stem.0.weight"].shape[1],
                num_classes=sd["classifier.0.bias"].shape[0], voxel_size=voxel_size, max_voxels=max_voxels)
    model.load_state_dict(convert_torchsparse_state_dict(sd))
    return model.eval()


# ------------------------------------------------------------ eval descriptor


def make_sparse_descriptor_fn(model: _SparseUNetBase, agg_type: str = "depth", depth_range: tuple = (1.0, 45.0)):
    """``describe(points, feats, mask) -> (16·C,)`` eval descriptor of
    ``model`` on its device, for ``EvaluationEngine(voxel_apply=...)``
    (FSVD) or ``point_voxel_apply=...`` (FPVD).  The points move by half a
    voxel before the model's floor quantisation, so that a point lands in
    ``round(p / voxel_size)`` as upstream quantises."""
    model.eval()

    @torch.inference_mode()
    def describe(points, feats, mask):
        out = model(points + 0.5 * model.voxel_size, feats, mask)
        return aggregate_sectors(out["logits"], out["coords"], out["mask"], agg_type=agg_type,
                                 depth_range=depth_range, voxel_size=model.voxel_size)

    return describe


def aggregate_sectors(logits: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor, agg_type: str = "depth",
                      depth_range: tuple = (1.0, 45.0), voxel_size: float = 0.05, num_sectors: int = 16):
    """Per-cloud descriptor: masked means of per-site features over 16
    sectors, concatenated (num_sectors·C,).  ``depth``: radial shells of
    ``|coords − mean|·voxel_size`` from ``depth_range[0] + 3`` to
    ``depth_range[1]`` (the first open at 0); ``sector``: azimuth wedges;
    ``all``: one masked mean (C,).  Empty sectors give zeros."""
    fmask = mask.to(logits.dtype)
    c = coords.to(logits.dtype)
    count = torch.clamp(fmask.sum(), min=1.0)
    c = c - (c * fmask[:, None]).sum(0) / count
    if agg_type == "all":
        return (logits * fmask[:, None]).sum(0) / count
    if agg_type == "sector":
        key = torch.atan2(c[:, 1], c[:, 0])
        edges = np.linspace(-np.pi - 1e-4, np.pi + 1e-4, num_sectors + 1)
    elif agg_type == "depth":
        key = torch.linalg.vector_norm(c, dim=-1) * voxel_size
        edges = np.linspace(depth_range[0] + 3, depth_range[1], num_sectors + 1)
        edges[0] = 0.0
    else:
        raise NotImplementedError(agg_type)
    edges = edges.astype(np.float32)
    chunks = []
    for i in range(num_sectors):
        sel = fmask * (key >= float(edges[i])) * (key < float(edges[i + 1]))
        chunks.append((logits * sel[:, None]).sum(0) / torch.clamp(sel.sum(), min=1.0))
    return torch.cat(chunks)
