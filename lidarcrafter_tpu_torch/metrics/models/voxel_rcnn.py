"""pcdet's Voxel R-CNN with a CenterHead, in eval mode, and its weights.

Port of the JAX package's ``metrics/models/voxel_rcnn.py``: MeanVFE →
VoxelBackBone8x (sparse convs, ``ops/sparse.py``) → HeightCompression →
BaseBEVBackbone → CenterHead → the Voxel R-CNN RoI head (when the
checkpoint holds one) → class-agnostic rotated NMS and the score threshold.
Functions over a parameter tree (nested dicts and lists of tensors) that
``utils/torch_ckpt.py::convert_voxel_rcnn`` reads from a released pcdet
checkpoint; layouts: sparse kernels (taps, Cin, Cout) with (z, y, x) taps,
2D conv kernels (O, I, kh, kw), transposed-conv kernels (I, O, kh, kw),
1×1 and Linear kernels (I, O).

Conventions follow pcdet: voxel coordinates are (z, y, x), the BatchNorms
of the backbones and the head use eps 1e-3, the RoI head's 1e-5.  Dense
maps are (H, W, C) at the functions' boundaries, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.iou3d import nms
from ...ops.sparse import sparse_conv3d_strided, submanifold_conv3d, voxelize_coords_mean
from ...ops.stack import voxel_query
from .detector import decode_boxes

_BN_EPS = 1e-3

# nuScenes CenterHead class groups (pcdet's CLASS_NAMES_EACH_HEAD)
NUSC_CLASS_GROUPS = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)


def _bn(p, x, eps: float = _BN_EPS):
    """Frozen BatchNorm over the last axis."""
    return (x - p["mean"]) / torch.sqrt(p["var"] + eps) * p["scale"] + p["bias"]


def _bn_chw(p, x, eps: float = _BN_EPS):
    """Frozen BatchNorm over axis 0 of a (C, H, W) map."""
    return F.batch_norm(x[None], p["mean"], p["var"], p["scale"], p["bias"], False, 0.0, eps)[0]


def _subm_block(p, f, coords, mask):
    """SubMConv3d (no bias) + BN + ReLU."""
    f = F.relu(_bn(p["bn"], submanifold_conv3d(f, coords, mask, p["conv"]["kernel"])))
    return torch.where(mask[:, None], f, 0.0)


def _spconv_block(p, f, coords, mask, *, kernel_size, stride, padding, max_voxels, in_spatial):
    """SparseConv3d (no bias) + BN + ReLU, its output sites bounded by
    spconv's grid of the stage's input dims ``in_spatial``."""
    f, coords, mask = sparse_conv3d_strided(f, coords, mask, p["conv"]["kernel"], kernel_size=kernel_size,
                                            stride=stride, padding=padding, max_voxels=max_voxels,
                                            out_spatial=in_spatial)
    return torch.where(mask[:, None], F.relu(_bn(p["bn"], f)), 0.0), coords, mask


def level_grid_dims(base_grid_zyx):
    """(Z, Y, X) of x_conv2 / 3 / 4 by VoxelBackBone8x's arithmetic (k3 s2
    p1 twice; conv4 without z padding)."""
    def down(v, k, s, p):
        return (v + 2 * p - k) // s + 1

    nz, ny, nx = base_grid_zyx
    dims = []
    for pz in (1, 1, 0):
        nz, ny, nx = down(nz, 3, 2, pz), down(ny, 3, 2, 1), down(nx, 3, 2, 1)
        dims.append((nz, ny, nx))
    return dims


def voxel_backbone_8x(p, feats, coords, mask, grid_zyx, max_voxels=(65536, 32768, 16384, 8192),
                      return_levels: bool = False):
    """pcdet ``VoxelBackBone8x``: conv_input, 4 stages, conv_out (z only).
    ``coords`` (z, y, x); ``grid_zyx`` the base grid bounding every
    stage's output sites.  With ``return_levels`` also x_conv2 / 3 / 4
    (strides 2 / 4 / 8), which the RoI head pools from."""
    f = _subm_block(p["conv_input"], feats, coords, mask)
    f = _subm_block(p["conv1"][0], f, coords, mask)
    pads = ((1, 1, 1), (1, 1, 1), (0, 1, 1))
    stage_dims = [tuple(grid_zyx)] + [tuple(d) for d in level_grid_dims(grid_zyx)]
    levels = []
    for i, name in enumerate(("conv2", "conv3", "conv4")):
        blocks = p[name]
        f, coords, mask = _spconv_block(blocks[0], f, coords, mask, kernel_size=(3, 3, 3), stride=(2, 2, 2),
                                        padding=pads[i], max_voxels=max_voxels[i + 1], in_spatial=stage_dims[i])
        for sub in blocks[1:]:
            f = _subm_block(sub, f, coords, mask)
        levels.append({"feats": f, "coords": coords, "mask": mask, "stride": 2 ** (i + 1)})
    f, coords, mask = _spconv_block(p["conv_out"], f, coords, mask, kernel_size=(3, 1, 1), stride=(2, 1, 1),
                                    padding=(0, 0, 0), max_voxels=max_voxels[-1], in_spatial=stage_dims[3])
    return (f, coords, mask, levels) if return_levels else (f, coords, mask)


def height_compression(f, coords, mask, nz: int, ny: int, nx: int):
    """pcdet ``HeightCompression``: the sparse (z, y, x) level → a dense
    (y, x, z·C) map; coordinates outside the grid are dropped."""
    C = f.shape[-1]
    c = coords.long()
    inb = mask & (c[:, 0] >= 0) & (c[:, 0] < nz) & (c[:, 1] >= 0) & (c[:, 1] < ny) & (c[:, 2] >= 0) & (c[:, 2] < nx)
    zi = torch.where(inb, c[:, 0], nz)
    dense = f.new_zeros(nz + 1, ny, nx, C).index_put_(
        (zi, torch.where(inb, c[:, 1], 0), torch.where(inb, c[:, 2], 0)), torch.where(inb[:, None], f, 0.0),
        accumulate=True)[:nz]
    return dense.permute(1, 2, 0, 3).reshape(ny, nx, nz * C)


def _conv2d(p, x, stride: int = 1):
    """(C, H, W) conv with symmetric padding k // 2 (torch Conv2d's)."""
    w = p["kernel"]
    return F.conv2d(x[None], w, p.get("bias"), stride, (w.shape[2] // 2, w.shape[3] // 2))[0]


def _conv2d_block(p, x, stride: int = 1):
    return F.relu(_bn_chw(p["bn"], _conv2d(p["conv"], x, stride)))


def bev_backbone(p, x):
    """pcdet ``BaseBEVBackbone`` on an (H, W, C) map: per block stacked 3×3
    convs (the first strided) and an upsampling deblock, concatenated."""
    x = x.permute(2, 0, 1)
    H0, W0 = x.shape[1], x.shape[2]
    ups = []
    h = x
    for blk, deblk in zip(p["blocks"], p["deblocks"]):
        h = _conv2d_block(blk[0], h, stride=blk[0]["stride"])
        for sub in blk[1:]:
            h = _conv2d_block(sub, h)
        if deblk["transpose"]:  # ConvTranspose2d(k=s, stride=s): an exact block scatter
            u = F.conv_transpose2d(h[None], deblk["conv"]["tkernel"], stride=deblk["stride"])[0]
        else:
            u = _conv2d(deblk["conv"], h)
        ups.append(F.relu(_bn_chw(deblk["bn"], u))[:, :H0, :W0])  # odd sizes: the transpose overshoots
    return torch.cat(ups, 0).permute(1, 2, 0)


def center_head(p, x):
    """pcdet ``CenterHead``: the shared conv, then each class group's
    separate heads (conv + BN + ReLU layers, a last conv with bias); a list
    of per-group dicts of (H, W, C) maps."""
    h = _conv2d_block(p["shared_conv"], x.permute(2, 0, 1))
    out = []
    for hp in p["heads_list"]:
        maps = {}
        for name, layers in hp.items():
            g = h
            for layer in layers[:-1]:
                g = _conv2d_block(layer, g)
            maps[name] = _conv2d(layers[-1]["conv"], g).permute(1, 2, 0)
        out.append(maps)
    return out


def decode_center_boxes(head_out: dict, point_range: torch.Tensor, voxel_size: torch.Tensor, k: int = 128,
                        feature_map_stride: int = 8):
    """CenterPoint decoding (pcdet ``decode_bbox_from_heatmap``): the top
    ``k`` of the sigmoid heatmap (ties to the lower index, as ``top_k``);
    centres (grid + offset)·stride·voxel + range, sizes exp(dim), yaw
    atan2(sin, cos).  Returns (boxes (k, 7), scores, classes int32)."""
    hm = torch.sigmoid(head_out["hm"])
    H, W, ncls = hm.shape
    scores, idx = torch.sort(hm.reshape(-1), descending=True, stable=True)
    scores, idx = scores[:k], idx[:k]
    cls = (idx % ncls).to(torch.int32)
    pix = idx // ncls
    ys, xs = (pix // W).float(), (pix % W).float()

    def at(name, d):
        return head_out[name].reshape(-1, d)[pix]

    center = at("center", 2)
    xs = (xs + center[:, 0]) * feature_map_stride * voxel_size[0] + point_range[0]
    ys = (ys + center[:, 1]) * feature_map_stride * voxel_size[1] + point_range[1]
    dim = torch.exp(at("dim", 3))
    rot = at("rot", 2)
    boxes = torch.stack([xs, ys, at("center_z", 1)[:, 0], dim[:, 0], dim[:, 1], dim[:, 2],
                         torch.atan2(rot[:, 0], rot[:, 1])], 1)
    return boxes, scores, cls


def params_to(params, device):
    """The parameter tree with its tensors on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device) if isinstance(params, torch.Tensor) else params


@dataclasses.dataclass
class VoxelRCNNCenterHead:
    """The eval-mode detector over one padded cloud.  ``params``: the tree
    of ``convert_voxel_rcnn``, on the device the clouds will be on;
    ``class_groups``: the class names of each CenterHead group."""

    params: Any
    class_groups: Sequence[Sequence[str]]
    point_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: Sequence[float] = (0.075, 0.075, 0.2)
    max_voxels: int = 65536
    topk_per_head: int = 128
    score_thresh: float = 0.1
    # pcdet POST_PROCESSING.NMS_CONFIG of the nuScenes CenterPoint / Voxel
    # R-CNN configs: class-agnostic, THRESH 0.2, POST_MAXSIZE 83
    nms_thresh: float = 0.2
    nms_post_maxsize: int = 83

    def to(self, device) -> "VoxelRCNNCenterHead":
        return dataclasses.replace(self, params=params_to(self.params, torch.device(device)))

    @property
    def grid_zyx(self):
        pr, vs = self.point_range, self.voxel_size
        return tuple(int(round((pr[3 + a] - pr[a]) / vs[a])) for a in (2, 1, 0))

    def _bev_zyx(self):
        dims = level_grid_dims(self.grid_zyx)[-1]
        return (dims[0] - 3) // 2 + 1, dims[1], dims[2]  # conv_out: z only, k3 s2 p0

    def voxelize(self, points, point_mask):
        """MeanVFE on the (z, y, x) grid anchored at the range minimum:
        (voxel features, coords, mask)."""
        pr = points.new_tensor(self.point_range)
        inr = point_mask & (points[:, :3] >= pr[:3]).all(-1) & (points[:, :3] < pr[3:] - 1e-3).all(-1)
        cell = torch.floor((points[:, :3] - pr[:3]) / points.new_tensor(self.voxel_size)).to(torch.int32)
        return voxelize_coords_mean(cell.flip(1), points, inr, max_voxels=self.max_voxels)

    def dense_maps(self, points, point_mask):
        """(per-group dicts of CenterHead maps (H, W, C), backbone levels
        for the RoI head, the voxel coords and mask)."""
        vox_feats, coords, vmask = self.voxelize(points, point_mask)
        f, c, m, levels = voxel_backbone_8x(self.params["backbone_3d"], vox_feats, coords, vmask, self.grid_zyx,
                                            return_levels=True)
        bev = height_compression(f, c, m, *self._bev_zyx())
        heads = center_head(self.params["dense_head"], bev_backbone(self.params["backbone_2d"], bev))
        return heads, levels, coords, vmask

    def forward(self, points, point_mask):
        """points (N, 3+F) → (per group (boxes (k, 7), scores, classes), the
        backbone levels for the RoI head)."""
        heads, levels, _, _ = self.dense_maps(points, point_mask)
        pr = points.new_tensor(self.point_range)
        vs = points.new_tensor(self.voxel_size[:2])
        return [decode_center_boxes(h, pr, vs, k=self.topk_per_head) for h in heads], levels

    def __call__(self, points, point_mask):
        """The raw CenterHead top-k proposals of each group."""
        return self.forward(points, point_mask)[0]

    @torch.inference_mode()
    def predict(self, points, point_mask):
        """Flat detections (boxes (K, 7), scores (K,), class names, valid):
        with a ``roi_head`` the proposals are refined and rescored once by
        the second stage; then pcdet's class-agnostic greedy rotated NMS,
        its ``NMS_POST_MAXSIZE`` and the score threshold make ``valid``."""
        per_head, levels = self.forward(points, point_mask)
        boxes = torch.cat([b for b, _, _ in per_head])
        scores = torch.cat([s for _, s, _ in per_head])
        if "roi_head" in self.params:
            boxes, scores = voxel_rcnn_roi_head(self.params["roi_head"], boxes,
                                                torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device),
                                                levels, self.point_range, self.voxel_size, self.grid_zyx)
        order, keep = nms(boxes, scores, self.nms_thresh)
        keep &= torch.cumsum(keep, 0) <= self.nms_post_maxsize
        nms_keep = torch.zeros_like(keep).index_put_((order,), keep)
        names = [list(self.class_groups[g])[int(ci)] for g, (_, _, c) in enumerate(per_head) for ci in c.tolist()]
        return boxes, scores, names, nms_keep & (scores >= self.score_thresh)


def load_voxel_rcnn_from_pcdet(ckpt_path, class_groups=NUSC_CLASS_GROUPS, device: str | torch.device = "cpu",
                               **kwargs) -> VoxelRCNNCenterHead:
    """A :class:`VoxelRCNNCenterHead` from a released pcdet checkpoint
    (``{'model_state': ...}``, ``{'state_dict': ...}``, ``{'net': ...}`` or a
    bare state dict), with as many class groups as it has heads, on
    ``device``."""
    from ...utils.torch_ckpt import convert_voxel_rcnn

    obj = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    for key in ("model_state", "state_dict", "net"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    n_heads = len({k.split(".")[2] for k in obj if k.startswith("dense_head.heads_list.")})
    if n_heads and n_heads != len(class_groups):
        class_groups = class_groups[:n_heads]
    return VoxelRCNNCenterHead(params=convert_voxel_rcnn(obj), class_groups=class_groups, **kwargs).to(device)


# -------------------------------------------------------- RoI refinement head


def roi_grid_points(rois: torch.Tensor, grid_size: int = 6) -> torch.Tensor:
    """(N, 7) rois → (N, G³, 3) global grid points (pcdet's
    ``get_global_grid_points_of_roi``): the (idx + 0.5)/G local grid scaled
    by the box, centred, turned by the yaw and moved to the box."""
    G = grid_size
    ar = torch.arange(G, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1).reshape(-1, 3).float()
    local = (idx + 0.5) / G * rois[:, None, 3:6] - rois[:, None, 3:6] / 2
    cos, sin = torch.cos(rois[:, 6, None]), torch.sin(rois[:, 6, None])
    x = local[..., 0] * cos - local[..., 1] * sin
    y = local[..., 0] * sin + local[..., 1] * cos
    return torch.stack([x, y, local[..., 2]], -1) + rois[:, None, :3]


def dense_point_index_grid(coords_zyx, mask, nz: int, ny: int, nx: int) -> torch.Tensor:
    """(V, 3) (z, y, x) coords → a (1, Z, Y, X) int32 grid of their rows,
    -1 where empty (pcdet's ``generate_voxel2pinds``); coordinates outside
    the grid are dropped."""
    c = coords_zyx.long()
    inb = mask & (c[:, 0] >= 0) & (c[:, 0] < nz) & (c[:, 1] >= 0) & (c[:, 1] < ny) & (c[:, 2] >= 0) & (c[:, 2] < nx)
    flat = torch.where(inb, (c[:, 0] * ny + c[:, 1]) * nx + c[:, 2], nz * ny * nx)
    grid = torch.full((nz * ny * nx + 1,), -1, dtype=torch.int32, device=coords_zyx.device)
    grid[flat] = torch.arange(c.shape[0], dtype=torch.int32, device=c.device)
    return grid[:-1].reshape(1, nz, ny, nx)


def _neighbor_pool(p, level, grid_xyz, grid_coords_bxyz, grid_mask, point_range, voxel_size, query_range, radius,
                   nsample):
    """One scale of ``NeighborVoxelSAModuleMSG``: mlp_in on the level's
    features, the voxel query, + the position MLP, ReLU, max over the
    neighbours, mlp_out (BN eps 1e-5)."""
    feats, coords, vmask = level["feats"], level["coords"], level["mask"]
    dev = feats.device
    vs = torch.tensor(np.asarray(voxel_size) * level["stride"], dtype=torch.float32, device=dev)
    centers = (coords.flip(1).float() + 0.5) * vs + torch.tensor(point_range[:3], dtype=torch.float32, device=dev)
    f_in = torch.where(vmask[:, None], _bn(p["mlp_in"]["bn"], feats @ p["mlp_in"]["conv"]["kernel"], 1e-5), 0.0)
    pind = dense_point_index_grid(coords, vmask, *level["grid_zyx"])
    idx, empty = voxel_query(grid_coords_bxyz[:, [0, 3, 2, 1]], grid_xyz, centers, pind, query_range=query_range,
                             radius=radius, nsample=nsample, new_mask=grid_mask)
    keep = (~empty & grid_mask)[:, None, None]
    idx = idx.long()
    grouped = torch.where(keep, f_in[idx], 0.0)
    gxyz = torch.where(keep, centers[idx] - grid_xyz[:, None, :], 0.0)
    h = F.relu(grouped + _bn(p["mlp_pos"]["bn"], gxyz @ p["mlp_pos"]["conv"]["kernel"], 1e-5)).amax(1)
    h = _bn(p["mlp_out"]["bn"], h @ p["mlp_out"]["conv"]["kernel"], 1e-5)
    return torch.where(grid_mask[:, None], F.relu(h), 0.0)


def _fc_stack(p, x):
    """[Linear (no bias) + BN1d (eps 1e-5) + ReLU]×n (pcdet ``make_fc_layers``)."""
    for layer in p:
        x = F.relu(_bn(layer["bn"], x @ layer["conv"]["kernel"], 1e-5))
    return x


def voxel_rcnn_roi_head(p, rois, roi_mask, levels, point_range, voxel_size, base_grid_zyx, grid_size: int = 6,
                        query_ranges=((4, 4, 4), (4, 4, 4), (4, 4, 4)), radii=(0.4, 0.8, 1.6),
                        nsamples=(16, 16, 16)):
    """pcdet ``VoxelRCNNHead``: 6³ RoI-grid pooling from x_conv2 / 3 / 4 →
    shared FCs → a class-agnostic confidence and a box residual decoded in
    the RoI's frame.  Returns (refined boxes (N, 7), sigmoid scores (N,))."""
    N = rois.shape[0]
    dev = rois.device
    grid_xyz = roi_grid_points(rois, grid_size).reshape(-1, 3)
    grid_mask = roi_mask.repeat_interleave(grid_size**3)
    dims = level_grid_dims(base_grid_zyx)
    pr = torch.tensor(point_range[:3], dtype=torch.float32, device=dev)
    pooled = []
    for k, level in enumerate(levels):
        level = dict(level, grid_zyx=dims[k])
        vs = torch.tensor(np.asarray(voxel_size) * level["stride"], dtype=torch.float32, device=dev)
        cell = torch.floor((grid_xyz - pr) / vs).to(torch.int32)
        coords_bxyz = torch.cat([torch.zeros_like(cell[:, :1]), cell], 1)  # (b, x, y, z), as upstream hands them
        pooled.append(_neighbor_pool(p["roi_grid_pool_layers"][k], level, grid_xyz, coords_bxyz, grid_mask,
                                     point_range, voxel_size, tuple(query_ranges[k]), float(radii[k]),
                                     int(nsamples[k])))
    pooled = torch.cat(pooled, -1).reshape(N, -1)
    shared = _fc_stack(p["shared_fc_layer"], pooled)
    rcnn_cls = _fc_stack(p["cls_fc_layers"], shared) @ p["cls_pred_layer"]["kernel"] + p["cls_pred_layer"]["bias"]
    rcnn_reg = _fc_stack(p["reg_fc_layers"], shared) @ p["reg_pred_layer"]["kernel"] + p["reg_pred_layer"]["bias"]
    local_rois = rois.clone()
    local_rois[:, 0:3] = 0.0
    local_rois[:, 6] = 0.0
    boxes_local = decode_boxes(rcnn_reg[:, :7], local_rois)
    cos, sin = torch.cos(rois[:, 6]), torch.sin(rois[:, 6])
    x = boxes_local[:, 0] * cos - boxes_local[:, 1] * sin
    y = boxes_local[:, 0] * sin + boxes_local[:, 1] * cos
    center = torch.stack([x, y, boxes_local[:, 2]], 1) + rois[:, :3]
    refined = torch.cat([center, boxes_local[:, 3:6], (boxes_local[:, 6] + rois[:, 6])[:, None]], 1)
    return refined, torch.sigmoid(rcnn_cls[:, 0])


def seeded_params(seed: int, in_dims: int = 4, channels=(16, 32, 64, 64, 128), bev_layers=(5, 5),
                  bev_filters=(128, 256), bev_up=(256, 256), bev_in: int | None = None, shared: int = 64,
                  class_groups=NUSC_CLASS_GROUPS, roi_mlp: int = 32, roi_fc: int = 256, grid: int = 6) -> dict:
    """A parameter tree of seeded weights (``numpy.random.default_rng(seed)``:
    kernels normal/√fan_in, BatchNorm scales 1 + 0.1·normal, biases and
    running means 0.1·normal, running variances 1 + 0.1·|normal|), for
    serving and measuring without a checkpoint.  The defaults are the
    widths of pcdet's nuScenes CenterPoint-style detector with the Voxel
    R-CNN head: VoxelBackBone8x 16-32-64-64 → 128, a BEV backbone of 5 + 5
    layers at 128 / 256 filters upsampled to 256 + 256, a 64-channel shared
    conv, a head per class group (centre 2, centre_z 1, dim 3, rot 2, vel 2,
    hm; one 64-channel conv before each), RoI pools of 32 channels on
    x_conv2 / 3 / 4 and FC stacks of 256.  ``bev_in`` is the BEV map's
    channels (``channels[-1]`` × the compressed z bins; 1 bin by default)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, fan_in):
        return torch.as_tensor((rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

    def vec(n, scale=0.1, base=0.0):
        return torch.as_tensor((base + scale * rng.standard_normal(n)).astype(np.float32))

    def bn(n):
        return {"scale": vec(n, base=1.0), "bias": vec(n), "mean": vec(n),
                "var": torch.as_tensor((1.0 + 0.1 * np.abs(rng.standard_normal(n))).astype(np.float32))}

    def sparse(cin, cout, taps=27):
        return {"conv": {"kernel": normal(taps, cin, cout, fan_in=taps * cin)}, "bn": bn(cout)}

    def conv(cin, cout, k=3, bias=True, norm=True):
        c = {"kernel": normal(cout, cin, k, k, fan_in=cin * k * k)}
        if bias:
            c["bias"] = vec(cout)
        return {"conv": c, "bn": bn(cout)} if norm else {"conv": c}

    c = channels
    b3 = {"conv_input": sparse(in_dims, c[0]), "conv1": [sparse(c[0], c[0])]}
    for i, name in enumerate(("conv2", "conv3", "conv4")):
        b3[name] = [sparse(c[i], c[i + 1])] + [sparse(c[i + 1], c[i + 1]) for _ in range(2)]
    b3["conv_out"] = sparse(c[3], c[4], taps=3)
    b2 = {"blocks": [], "deblocks": []}
    cin = bev_in or c[4]
    for i, (n, f, up) in enumerate(zip(bev_layers, bev_filters, bev_up)):
        b2["blocks"].append([dict(conv(cin if j == 0 else f, f, bias=False), stride=(1, 2)[i] if j == 0 else 1)
                             for j in range(n + 1)])
        s = (1, 2)[i]
        d = {"tkernel": normal(f, up, s, s, fan_in=f)} if s > 1 else conv(f, up, 1, bias=False)["conv"]
        b2["deblocks"].append({"conv": d, "bn": bn(up), "stride": s, "transpose": s > 1})
        cin = f
    targets = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2}
    heads = [{name: [conv(shared, shared), conv(shared, d, norm=False)]
              for name, d in sorted({**targets, "hm": len(g)}.items())} for g in class_groups]
    out = {"backbone_3d": b3, "backbone_2d": b2,
           "dense_head": {"shared_conv": conv(sum(bev_up), shared), "heads_list": heads}}

    def lin(cin, cout):
        return {"kernel": normal(cin, cout, fan_in=cin)}

    def fcs(cin):
        return [{"conv": lin(cin, roi_fc), "bn": bn(roi_fc)}, {"conv": lin(roi_fc, roi_fc), "bn": bn(roi_fc)}]

    pools = [{"mlp_in": {"conv": lin(ch, roi_mlp), "bn": bn(roi_mlp)},
              "mlp_pos": {"conv": lin(3, roi_mlp), "bn": bn(roi_mlp)},
              "mlp_out": {"conv": lin(roi_mlp, roi_mlp), "bn": bn(roi_mlp)}} for ch in c[1:4]]
    out["roi_head"] = {"roi_grid_pool_layers": pools, "shared_fc_layer": fcs(grid**3 * roi_mlp * 3),
                       "cls_fc_layers": fcs(roi_fc), "reg_fc_layers": fcs(roi_fc),
                       "cls_pred_layer": dict(lin(roi_fc, 1), bias=vec(1)),
                       "reg_pred_layer": dict(lin(roi_fc, 7), bias=vec(7))}
    return out
