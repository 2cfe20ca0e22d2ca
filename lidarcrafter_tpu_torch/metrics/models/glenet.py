"""GLENet: the CVAE box-uncertainty model behind RGF.

Port of the JAX package's ``metrics/models/glenet.py``: a prior encoder
p(z|x), a posterior encoder q(z|x, y) and a SimPointNet box decoder, each
over (B, N, C) points with a 512-d CLIP text feature.  Training: smooth-L1
on sin-difference-encoded boxes + direction-bin cross-entropy + KL(q‖p)
(+ the trainer's annealing and L2 term); inference draws ``z ~ p(z|x)``
for each Monte-Carlo pass and decodes the heading from the direction bins.

The normal draw ``eps`` is explicit: pass it as a tensor (tests inject the
JAX package's draw), or a ``torch.Generator`` to draw it from; at eval
without either, ``z`` is the prior mean.  The BatchNorms follow flax
(``models/batch_norm.py``), and the submodules carry the flax names, so a
flax variable dict, or an upstream state dict through
``utils/torch_ckpt.py::convert_glenet``, loads through
``weights.load_flax_params``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from ...models.batch_norm import BatchNorm
from ...training.optim import AdamW, cosine_onecycle_schedule

TEXT_DIM = 512  # CLIP text feature

# exp20.yaml: the fold-training recipe RGF uses (MODEL + LOSS_WEIGHTS)
EXP20_KWARGS = dict(latent_size=8, dir_offset=0.78539, loc_weight=10.0, dir_weight=0.002, latent_weight=10.0)


class GLEPointNetFeat(nn.Module):
    """x (B, N, C) + text (B, 512) → (B, 512·width), or (B, 16·width) in the
    SimPointNet variant (``sim``)."""

    def __init__(self, in_channels: int = 3, width: float = 1.0, sim: bool = False):
        super().__init__()
        if sim:
            chans = [int(16 * width)] * 3
            seq = (256, int(16 * width))
        else:
            chans = [int(64 * width), int(128 * width), int(512 * width)]
            seq = (768, 512)
        c_in = in_channels
        for i, c in enumerate(chans):
            setattr(self, f"conv{i + 1}", nn.Linear(c_in, c))
            setattr(self, f"bn{i + 1}", BatchNorm(c))
            c_in = c
        self.seq0 = nn.Linear(chans[-1] + TEXT_DIM, seq[0])
        self.seq1 = nn.Linear(seq[0], seq[1])
        self.out_features = seq[1]

    def forward(self, x: torch.Tensor, text_feat: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = x
        for i in range(3):
            h = getattr(self, f"bn{i + 1}")(getattr(self, f"conv{i + 1}")(h), train)
            if i < 2:
                h = F.relu(h)
        h = torch.cat([h.amax(dim=1), text_feat], dim=1)
        return self.seq1(F.relu(self.seq0(h)))


class LatentEncoder(nn.Module):
    """Encoder_x / Encoder_xy (``conditional``: also the (B, 8) box input):
    (mu, logvar), logvar clipped to ±8 (scale = exp(logvar))."""

    def __init__(self, latent_size: int = 3, conditional: bool = False, in_channels: int = 3):
        super().__init__()
        self.conditional = conditional
        self.fe = GLEPointNetFeat(in_channels)
        h = self.fe.out_features + (8 if conditional else 0)
        self.fc1 = nn.Linear(h, latent_size)
        self.fc2 = nn.Linear(h, latent_size)

    def forward(self, x, text_feat, y=None, train: bool = False):
        h = self.fe(x, text_feat, train)
        if self.conditional:
            h = torch.cat([h, y], dim=1)
        return self.fc1(h), torch.clamp(self.fc2(h), -8.0, 8.0)


class ObjectFeatEncoder(nn.Module):
    """The box decoder: centres (3), sizes (3), heading (1), direction bins."""

    def __init__(self, latent_dim: int = 3, num_bins: int = 2, in_channels: int = 3):
        super().__init__()
        self.fe = GLEPointNetFeat(in_channels, width=0.5, sim=True)
        w = 64  # 256 · fc_scale (0.25)
        self.fc1, self.bn1 = nn.Linear(self.fe.out_features + latent_dim, w), BatchNorm(w)
        self.fc2, self.bn2 = nn.Linear(w, w), BatchNorm(w)
        for name, out in (("fc_ce", 3), ("fc_s", 3), ("fc_hr", 1), ("fc_dir", num_bins)):
            setattr(self, f"{name}1", nn.Linear(w, w))
            setattr(self, f"{name}2", nn.Linear(w, out, bias=False))

    def forward(self, x, text_feat, z, train: bool = False):
        h = torch.cat([self.fe(x, text_feat, train), z], dim=1)
        h = F.relu(self.bn1(self.fc1(h), train))
        feat = F.relu(self.bn2(self.fc2(h), train))

        def head(name):
            return getattr(self, f"{name}2")(F.relu(getattr(self, f"{name}1")(feat)))

        return torch.cat([head("fc_ce"), head("fc_s"), head("fc_hr"), head("fc_dir")], dim=1)


def kl_diag_gaussians(mu_q, logvar_q, mu_p, logvar_p):
    """KL(q‖p) of diagonal Gaussians with scale = exp(logvar)."""
    var_q, var_p = torch.exp(2 * logvar_q), torch.exp(2 * logvar_p)
    kl = logvar_p - logvar_q + (var_q + (mu_q - mu_p) ** 2) / (2 * var_p) - 0.5
    return kl.sum(dim=-1)


def add_sin_difference(boxes1, boxes2, dim: int = 6):
    """The heading pair as sin(a)cos(b) and cos(a)sin(b)."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(reg_targets, dir_offset: float = 0.0, num_bins: int = 2):
    """Heading → one-hot direction bin."""
    rot = reg_targets[..., 6] - dir_offset
    offset_rot = rot - torch.floor(rot / (2 * math.pi)) * (2 * math.pi)
    dir_cls = torch.clamp(torch.floor(offset_rot / (2 * math.pi / num_bins)).to(torch.int64), 0, num_bins - 1)
    return F.one_hot(dir_cls, num_bins).to(reg_targets.dtype)


def smooth_l1(diff, beta: float = 1.0 / 9.0):
    """pcdet's WeightedSmoothL1Loss at its default beta."""
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad**2 / beta, ad - 0.5 * beta)


class GLENet(nn.Module):
    """``forward(batch, eps=None, train=False, generator=None)``.  ``batch``:
    ``points`` (B, N, C), ``text_feat`` (B, 512), and to train
    ``gt_boxes_input`` (B, 8) / ``gt_boxes`` (B, 7).  Train: (reg_loss,
    latent_loss, box_pred); eval: the (B, 9) boxes with the heading
    corrected by the argmax direction bin."""

    def __init__(self, latent_size: int = 3, num_bins: int = 2, dir_offset: float = 0.0, loc_weight: float = 1.0,
                 dir_weight: float = 0.2, latent_weight: float = 1.0, point_dims: int = 3):
        super().__init__()
        self.latent_size, self.num_bins, self.dir_offset = latent_size, num_bins, dir_offset
        self.loc_weight, self.dir_weight, self.latent_weight = loc_weight, dir_weight, latent_weight
        self.x_encoder = LatentEncoder(latent_size, in_channels=point_dims)
        self.xy_encoder = LatentEncoder(latent_size, conditional=True, in_channels=point_dims)
        self.obj_encoder = ObjectFeatEncoder(latent_size, num_bins, in_channels=point_dims)

    def _eps(self, eps, like, generator):
        if eps is not None:
            return eps.to(like)
        return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)

    def forward(self, batch: dict, eps: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None):
        x, text_feat = batch["points"], batch["text_feat"]
        if train:
            labels = batch["gt_boxes"]
            mu_q, logvar_q = self.xy_encoder(x, text_feat, batch["gt_boxes_input"], train)
            mu_p, logvar_p = self.x_encoder(x, text_feat, train=train)
            latent_loss = kl_diag_gaussians(mu_q, logvar_q, mu_p, logvar_p).mean() * self.latent_weight
            std = torch.exp(0.5 * logvar_q)
            z = mu_q + self._eps(eps, std, generator) * std
            box_pred = self.obj_encoder(x, text_feat, z, train)
            B = box_pred.shape[0]
            pred_sin, tg_sin = add_sin_difference(box_pred[:, :7], labels)
            loc_loss = smooth_l1(pred_sin - tg_sin).sum() / B * self.loc_weight
            dir_tg = get_direction_target(labels, self.dir_offset, self.num_bins)
            dir_logits = box_pred[:, -self.num_bins:]
            dir_loss = (-dir_tg * F.log_softmax(dir_logits, dim=-1)).sum() / B * self.dir_weight
            return loc_loss + dir_loss, latent_loss, box_pred
        mu_p, logvar_p = self.x_encoder(x, text_feat)
        std = torch.exp(0.5 * logvar_p)
        if eps is None and generator is None:
            z = mu_p
        else:
            z = mu_p + self._eps(eps, std, generator) * std
        box_pred = self.obj_encoder(x, text_feat, z)
        dir_labels = box_pred[:, -self.num_bins:].argmax(dim=-1)
        period = 2 * math.pi / self.num_bins
        rot = box_pred[..., 6] - self.dir_offset
        dir_rot = rot - torch.floor(rot / period) * period
        heading = dir_rot + self.dir_offset + period * dir_labels.to(box_pred.dtype)
        return torch.cat([box_pred[:, :6], heading[:, None], box_pred[:, 7:]], dim=1)


@torch.no_grad()
def mc_uncertainty(apply_fn, batch: dict, draws, num_passes: int = 30):
    """Variance (and mean) of the box predictions over ``num_passes`` prior
    samples: ``apply_fn(batch, eps)`` with ``draws(i)`` the pass's draw."""
    preds = torch.stack([apply_fn(batch, draws(i)) for i in range(num_passes)])  # (P, B, 9)
    return preds[..., :7].var(dim=0, unbiased=False), preds.mean(dim=0)


def l2_param_norm(params) -> torch.Tensor:
    """Σ ‖p‖₂ over the parameters (norms, not squared norms), each smoothed
    by 1e-12 under the root: d‖p‖/dp at p = 0 is 0/0."""
    return sum(torch.sqrt(p.square().sum() + 1e-12) for p in params)


def make_glenet_optimizer(lr: float = 0.003, total_steps: int = 1000, weight_decay: float = 0.01,
                          grad_clip: float = 10.0, pct_start: float = 0.4, div_factor: float = 10.0) -> AdamW:
    """exp20's adam_onecycle: clip the global norm at 10, then AdamW
    (decoupled weight decay, b2 0.999) on the cosine one-cycle LR."""
    sched = cosine_onecycle_schedule(max(total_steps, 1), lr, pct_start=pct_start, div_factor=div_factor)
    return AdamW(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay, grad_clip=grad_clip)


def make_glenet_train_step(model: GLENet, tx: AdamW):
    """``step(opt_state, batch, anneal, eps=None, generator=None) ->
    {'loss', 'reg', 'latent'}`` (tensors): loss = reg + anneal·KL +
    1e-4·Σ‖W‖₂ over the parameters; the BatchNorms' running statistics
    update from the batch, the parameters and ``opt_state``
    (``tx.init(list(model.parameters()))``) in place."""
    params = list(model.parameters())

    def step(opt_state: dict, batch: dict, anneal: float, eps=None, generator=None) -> dict:
        reg, latent, _ = model(batch, eps=eps, train=True, generator=generator)
        loss = reg + anneal * latent + 1e-4 * l2_param_norm(params)
        grads = torch.autograd.grad(loss, params)
        tx.update_(params, list(grads), opt_state)
        return {"loss": loss.detach(), "reg": reg.detach(), "latent": latent.detach()}

    return step


def save_glenet_fold(path, model: GLENet, model_kwargs: dict) -> None:
    """A fold checkpoint: ``state.pt`` (the ``state_dict``, running
    statistics included) and ``config.json`` (``{"model_kwargs"}``), in the
    port's checkpoint layout."""
    from ...training.checkpoint import save_checkpoint
    from ...training.state import TrainState

    save_checkpoint(path, TrainState(step=0, models={"model": model}, ema={}, opt_state={}),
                    {"model_kwargs": dict(model_kwargs)})


def load_glenet_fold(path, device: str | torch.device = "cpu") -> GLENet:
    """The GLENet of a fold checkpoint written by ``train_glenet``, in eval
    mode on ``device``."""
    from ...training.checkpoint import load_weights

    cfg = json.loads((Path(path) / "config.json").read_text())
    model = GLENet(**cfg.get("model_kwargs", {}))
    load_weights(path, {"model": model}, ema=False)
    return model.to(device).eval()


def load_glenet_from_torch(ckpt_path, device: str | torch.device = "cpu", **model_kwargs) -> GLENet:
    """The GLENet of an upstream checkpoint (a plain state dict, or one
    under ``model_state`` / ``net`` / ``state_dict``), read through
    ``utils/torch_ckpt.py::convert_glenet``; its point dims come from the
    first point layer."""
    from ...utils.torch_ckpt import convert_glenet
    from ...weights import load_flax_params

    obj = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    for key in ("model_state", "net", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    sd = {k: v for k, v in obj.items() if "num_batches_tracked" not in k}
    variables = convert_glenet(sd)
    point_dims = variables["params"]["x_encoder"]["fe"]["conv1"]["kernel"].shape[0]
    model = GLENet(point_dims=point_dims, **model_kwargs)
    return load_flax_params(model, variables).to(device).eval()
