"""One rank of the CPU checks of the port's ``sp`` axis
(``tests/test_torch_port_sp.py``): ``python tests/torch_port_sp_ranks.py
RANK WORLD PORT DIR`` joins a gloo group of WORLD (4) processes at
``localhost:PORT``, runs every case on a (2, 2) and a (1, 4) mesh, and rank 0
writes the results to ``DIR/results.pt``.  ``DIR/inputs.pt`` holds what the
test prepared: the configs and weights of the small stacks, their inputs
and the JAX package's forwards are compared by the test itself.

Each case runs the sharded computation inside ``Mesh.active`` on this
rank's share of a global input made from a seed, gathers the result, and
records it beside the same computation in one process (in this process,
without a mesh): outputs, the input's gradient (gathered) and the
parameters' gradients (summed over the ``sp`` ranks) of ``sum(out · R)``
for a random global R; the cases named "... jvp" also the tangent along a
random global direction, under ``torch.func.jvp`` and under a
``forward_ad`` dual (whose exchanges carry primal and tangent together;
its primal is the one back-propagated).  The train steps (the auto-reg-v2
and v0 stacks, the discrete engine's loss) run on the (2, 2) mesh with a
loss mask whose shards hold different counts; the layout and object
trainers run one step on a (2, 2) ``DataParallel`` group, where the ``sp``
ranks replicate, beside the same step in one process.  MeanFlow
(``meanflow-nusc``): the stack's forward, its tangent du/dt along
(v, 1, 0), the exchanges of one call with and without a tangent and the
one-step sample; the loss and gradients of one step on the (2, 2) mesh with
the JAX key chain's draws injected; ``train.main --sp 2 --synthetic-data``
on the (2, 2) group beside the same command in one process.  Imports torch
and the port only.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import io
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.autograd import forward_ad

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lidarcrafter_tpu_torch import train as train_cli  # noqa: E402
from lidarcrafter_tpu_torch.diffusion.conditional import AZIMUTH_KEYS  # noqa: E402
from lidarcrafter_tpu_torch.models import build_model, ops  # noqa: E402
from lidarcrafter_tpu_torch.models import encoding as enc  # noqa: E402
from lidarcrafter_tpu_torch.models import hdit, layout_unet, openai_unet  # noqa: E402
from lidarcrafter_tpu_torch.parallel.ddp import DataParallel  # noqa: E402
from lidarcrafter_tpu_torch.parallel.mesh import azimuth, batch_sharding, make_mesh  # noqa: E402
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training, build_flow_training  # noqa: E402
from lidarcrafter_tpu_torch.training.loop import LayoutTrainer, ObjectTrainer  # noqa: E402
from lidarcrafter_tpu_torch.training.optim import make_optimizer  # noqa: E402
from lidarcrafter_tpu_torch.training.state import TrainState  # noqa: E402
from lidarcrafter_tpu_torch.training.train_step import loss_and_grads, make_train_step, step_generator  # noqa: E402
from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_points, synthetic_scene_graph_items  # noqa: E402
from lidarcrafter_tpu_torch.datasets.scene_graph import collate_scene_graphs  # noqa: E402
from lidarcrafter_tpu_torch.weights import init_random_  # noqa: E402

LAYER_SHAPE = (2, 8, 32, 32)  # B, H, W, C: W / 4 = 8 columns a rank at sp = 4; 32 channels for GroupNorm32
LAYERS = ("ring_pad", "RingConv", "Resample up", "Resample down", "FusedGN", "AdaGN", "SelfAttention2d",
          "ring_pad zeros", "RingConv zeros", "Downsample zeros", "Upsample zeros", "GLIDEAttentionBlock",
          "SpatialTransformer", "SpatialTransformer self", "HDiT neighbourhood", "HDiT global",
          "MFSelfAttention2d", "ring_pad jvp", "ring_pad zeros jvp", "gather_w jvp", "sum_sp jvp", "FusedGN jvp",
          "AdaGN jvp", "MFSelfAttention2d jvp")
WINDOWS = ("ring_pad", "ring_pad zeros")  # a rank's output is a window of the whole padded tensor
REPLICATED = ("gather_w", "sum_sp")  # every rank's output is the whole one-process output
# Upsample's conv runs at twice the input's H and W: its input is half as
# high and wide, so that its output, and the sums of its parameters'
# gradients (float32, summed over the shards in another order), are as large
# as the other cases'.  HDiT's global attention runs at its middle level
# only, the coarsest (W / 32 tokens): a (4, 8) level of tokens, as
# test_torch_port_hdit.py holds it
INPUT_SHAPE = {"Upsample zeros": (2, 4, 16, 32), "HDiT global": (2, 4, 8, 32)}


def layer(name: str) -> tuple[torch.nn.Module, callable]:
    """A seeded module and how to call it on NHWC ``x``."""
    torch.manual_seed(11)
    B, H, W, C = INPUT_SHAPE.get(name, LAYER_SHAPE)
    if name in WINDOWS:
        return torch.nn.Identity(), lambda m, x: ops.ring_pad(x, (2, 1, 1, 0), ring=name == "ring_pad")
    if name in ("RingConv", "RingConv zeros"):
        m = ops.RingConv(C, 8, ring=name == "RingConv")
        return m, lambda m, x: m(x)
    if name == "Downsample zeros":  # v0's down step: a stride-2 conv, zero-padded
        return layout_unet.Downsample(C, ring=False), lambda m, x: m(x)
    if name == "Upsample zeros":
        return layout_unet.Upsample(C, ring=False), lambda m, x: m(x)
    if name == "GLIDEAttentionBlock":  # 2 heads of 16, the encoder's 13 tokens in front
        m = layout_unet.GLIDEAttentionBlock(C, 2, encoder_channels=12)
        cond = {"xf_out": torch.randn(B, 13, 12)}
        return m, lambda m, x: m(x, cond)
    if name.startswith("SpatialTransformer"):  # self-attention, then over a context or (self) itself again
        context = None if name.endswith("self") else torch.randn(B, 5, 12)
        m = openai_unet.SpatialTransformer(C, 2, 8, 1, None if context is None else 12)
        return m, lambda m, x: m(x, context)
    if name.startswith("HDiT"):  # 2 heads of 16 over a level of token coordinates
        coords = hdit._pool2(torch.as_tensor(enc.generate_polar_coords(H, 4 * W), dtype=torch.float32), 1, 4)
        kernel = (3, 9) if name.endswith("neighbourhood") else None
        m = hdit.SelfAttention(C, 12, 2, coords, (4, 16), kernel)
        emb = torch.randn(B, 12)
        return m, lambda m, x: m(x, emb)
    if name == "Resample up":
        return ops.Resample(up=2), lambda m, x: m(x)
    if name == "Resample down":
        return ops.Resample(down=2), lambda m, x: m(x)
    if name == "FusedGN":
        m = ops.FusedGN(C, 4)
        with torch.no_grad():
            m.weight.normal_(1.0, 0.1)
            m.bias.normal_(0.0, 0.1)
        return m, lambda m, x: m(x, silu=True)
    if name == "AdaGN":
        m = ops.AdaGN(C, 12, 4)
        emb = torch.randn(LAYER_SHAPE[0], 12)
        return m, lambda m, x: m(x, emb, silu=True)
    if name == "SelfAttention2d":
        m = ops.SelfAttention2d(C, num_heads=2, gn_num_groups=4)
        return m, lambda m, x: m(x)
    if name == "MFSelfAttention2d":  # 2 heads of 16, qk-norm gains off 1
        m = ops.MFSelfAttention2d(C, num_heads=2, gn_num_groups=4)
        with torch.no_grad():
            m.q_norm_g.fill_(1.3)
            m.k_norm_g.fill_(0.8)
        # the scalar gains' gradients sum every logit's, which cancel over
        # each query's keys: a shard's order of the sums and one process's
        # round them up to ~5e-6 of their size apart in float32; they are
        # held, with every other gradient, in MeanFlow's train step (1e-4)
        m.q_norm_g.requires_grad_(False)
        m.k_norm_g.requires_grad_(False)
        return m, lambda m, x: m(x)
    if name == "gather_w":  # the whole W on every rank
        return torch.nn.Identity(), lambda m, x: x if azimuth() is None else azimuth().gather_w(x)
    if name == "sum_sp":  # the column sum of the whole W on every rank
        return torch.nn.Identity(), lambda m, x: (x.sum(dim=2, keepdim=True) if azimuth() is None
                                                  else azimuth().sum_sp(x.sum(dim=2, keepdim=True)))
    raise KeyError(name)


def grads_of(module: torch.nn.Module) -> list[torch.Tensor]:
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in module.parameters()]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def run_layer(name: str, mesh) -> dict:
    """The layer on this rank's columns against the layer on the whole.
    A rank's ``ring_pad`` is a window of the whole padded tensor (its
    columns and their halos), which the ranks' windows overlap, and a
    gather's or a sum's output is the whole one on every rank: each rank
    weights its output with its own R.  A case named "NAME jvp" runs NAME
    with a tangent: under ``torch.func.jvp`` (``tangent``) and as a
    ``forward_ad`` dual (``tangent_forward_ad``, whose primal is the one
    back-propagated)."""
    jvp = name.endswith(" jvp")
    base = name.removesuffix(" jvp")
    module, call = layer(base)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(INPUT_SHAPE.get(base, LAYER_SHAPE), generator=gen)
    dx = torch.randn(x.shape, generator=gen)
    cols = mesh.columns(x.shape[2])
    xs, dxs = x[:, :, cols].clone().requires_grad_(), dx[:, :, cols].clone()
    tangents = {}
    with mesh.active():
        if jvp:
            _, tangents["tangent"] = torch.func.jvp(lambda a: call(module, a), (xs.detach(),), (dxs,))
            with forward_ad.dual_level():
                y, tangents["tangent_forward_ad"] = forward_ad.unpack_dual(call(module, forward_ad.make_dual(xs, dxs)))
        else:
            y = call(module, xs)
    whole = base in WINDOWS or base in REPLICATED  # a rank's output is not its columns of the whole one
    if whole:
        r = torch.randn((mesh.sp, *y.shape), generator=gen)
        (y * r[mesh.sp_index]).sum().backward()
        y, tangents = mesh.gather_sp(y.detach()), {k: mesh.gather_sp(t.detach()) for k, t in tangents.items()}
    else:
        r = torch.randn((*y.shape[:2], y.shape[2] * mesh.sp, y.shape[3]), generator=gen)
        (y * r[:, :, mesh.columns(r.shape[2])]).sum().backward()
        y, tangents = mesh.gather_w(y.detach()), {k: mesh.gather_w(t.detach()) for k, t in tangents.items()}
    gx = mesh.gather_w(xs.grad)
    gp = grads_of(module)
    for g in gp:
        dist.all_reduce(g, group=mesh.sp_group)
    module.zero_grad()
    xw = x.clone().requires_grad_()
    want = call(module, xw)
    _, want_t = torch.func.jvp(lambda a: call(module, a), (x,), (dx,)) if jvp else (None, None)

    def as_ranks(t):
        """The one-process output as the ranks hold it."""
        if base in REPLICATED:
            return torch.stack([t] * mesh.sp)
        if base in WINDOWS:
            n = x.shape[2] // mesh.sp
            return torch.stack([t[:, :, j * n: j * n + y.shape[3]] for j in range(mesh.sp)])
        return t

    want = as_ranks(want)
    (want * r).sum().backward()
    wp = grads_of(module)
    total = float(torch.cat([w.flatten() for w in wp]).norm()) if wp else 0.0
    # per tensor, where its gradient is not zero up to rounding (an
    # attention key bias has none: a shift of every key's logit cancels)
    p_err = max((float((a - b).norm()) / float(b.norm()) for a, b in zip(gp, wp) if float(b.norm()) > 1e-6 * total),
                default=0.0)
    out = {"out": rel(y, want.detach()), "grad_x": rel(gx, xw.grad), "grad_params": p_err,
           "shape": list(want.shape)}
    if jvp:
        want_t = as_ranks(want_t)
        out.update({k: rel(t, want_t) for k, t in tangents.items()}, tangent_scale=float(want_t.abs().max()))
    return out


def build(case: dict) -> tuple[dict, object]:
    """The case's modules with its weights (``state``; seeded random ones
    through ``weights.init_random_`` where it has none) and its engine
    (None for a bare ``OpenAIUNet``)."""
    if case["kind"] == "openai":
        mods, engine = {"model": build_model("openai_unet", **case["kw"]).eval()}, None
    elif case["kind"] == "flow":
        model, engine, _ = build_flow_training(case["cfg"], "cpu")
        mods = {"model": model}
    else:
        models, engine, _ = build_diffusion_training(case["cfg"], "cpu")
        mods = models if isinstance(models, dict) else {"model": models}
    for i, (k, m) in enumerate(sorted(mods.items())):
        if "state" in case:
            m.load_state_dict(case["state"][k])
        else:
            init_random_(m, 5 + i)
    return mods, engine


def forward(case: dict, mods: dict, mesh=None) -> torch.Tensor:
    """The case's denoiser on its whole input, or with a ``mesh`` on this
    rank's rows and columns of it (the condition's rows; the columns of its
    maps), gathered."""
    x, t, kind = case["x"], case["t"], case["kind"]
    sharding = None if mesh is None else batch_sharding(mesh, 4, sp_axis=2)

    def rows(v):
        return v if mesh is None or v is None else batch_sharding(mesh, v.ndim).cut(v)

    with torch.no_grad(), contextlib.nullcontext() if mesh is None else mesh.active():
        xs = x if mesh is None else sharding.cut(x)
        if kind == "uncond":
            out = mods["model"](xs, rows(t))
        elif kind == "flow":
            out = mods["model"](xs, rows(t), rows(case["r"]))
        elif kind == "cond":
            batch = case["batch"] if mesh is None else mesh.cut_batch(case["batch"], AZIMUTH_KEYS)
            out = mods["model"](xs, {"time_condition": rows(t), "other_condition": mods["cond"](batch)})
        else:
            cd = {"time_condition": rows(t)}
            if case.get("ctx") is not None:
                cd["other_condition"] = rows(case["ctx"])
            out = mods["model"](xs, cd, y=rows(case.get("y")))
    return out if mesh is None else sharding.gather(out)


def stack_case(name: str, inputs: dict, mesh, out: dict) -> None:
    """The small stack's forward on the mesh and in one process; for the
    stacks with an ``x_T``, a DDIM@2 sample and (with the GroupNorm
    statistics taken from the gathered activations: every op but the
    statistics exactly as in one process) the same sample again."""
    case = inputs[name]
    mods, engine = build(case)
    out[name] = {"forward": forward(case, mods, mesh), "forward_one": forward(case, mods)}
    if "x_T" not in case:
        return
    # the samples on this rank's sp group alone, the whole batch on each:
    # the control is bit for bit only where every op sees one process's
    # batch (a convolution of one row and of two may round apart)
    cond = case.get("batch")
    x_T, sp_mesh = case["x_T"], mesh.sp_only()
    args = () if cond is None else (cond,)
    local_args = () if cond is None else (sp_mesh.cut_batch(cond, AZIMUTH_KEYS),)
    sample = engine.sample(*local_args, x_T.shape[0], 2, mode="ddim", x_T=x_T, mesh=sp_mesh)
    sample_one = engine.sample(*args, x_T.shape[0], 2, mode="ddim", x_T=x_T)
    with whole_statistics():
        sample_whole_stats = engine.sample(*local_args, x_T.shape[0], 2, mode="ddim", x_T=x_T, mesh=sp_mesh)
    out[name].update(sample=sample, sample_one=sample_one, sample_whole_stats=sample_whole_stats)


def flow_case(name: str, inputs: dict, mesh, out: dict) -> None:
    """MeanFlow's stack on the (2, 2) mesh beside one process: the forward,
    the tangent du/dt along (v, 1, 0) (the loss's
    jvp), the exchanges of one call without a tangent, under
    ``torch.func.jvp`` and as a ``forward_ad`` dual, and the one-step
    sample on the rank's sp group (with merged and with whole statistics)."""
    case = inputs[name]
    mods, engine = build(case)
    model = mods["model"]
    out[name] = {"forward": forward(case, mods, mesh), "forward_one": forward(case, mods)}
    x, v, t, r = case["x"], case["v"], case["t"], case["r"]
    sharding, rows = batch_sharding(mesh, 4, sp_axis=2), batch_sharding(mesh, 1)
    xs, vs, ts, rs = sharding.cut(x), sharding.cut(v), rows.cut(t), rows.cut(r)
    counts = {}
    with torch.no_grad(), mesh.active():
        e0 = mesh.exchanges
        model(xs, ts, rs)
        counts["no tangent"] = mesh.exchanges - e0
        e0 = mesh.exchanges
        _, tangent = torch.func.jvp(model, (xs, ts, rs), (vs, torch.ones_like(ts), torch.zeros_like(rs)))
        counts["torch.func.jvp"] = mesh.exchanges - e0
        e0 = mesh.exchanges
        with forward_ad.dual_level():
            dual = forward_ad.unpack_dual(model(forward_ad.make_dual(xs, vs), forward_ad.make_dual(ts, torch.ones_like(ts)),
                                                rs)).tangent
        counts["forward_ad"] = mesh.exchanges - e0
    with torch.no_grad():
        _, tangent_one = torch.func.jvp(model, (x, t, r), (v, torch.ones_like(t), torch.zeros_like(r)))
    sp_mesh = mesh.sp_only()
    out[name].update(tangent=sharding.gather(tangent), tangent_forward_ad=sharding.gather(dual), tangent_one=tangent_one,
                     exchanges=counts, sample=engine.sample(z=case["z"], mesh=sp_mesh),
                     sample_one=engine.sample(z=case["z"]))
    with whole_statistics():
        out[name]["sample_whole_stats"] = engine.sample(z=case["z"], mesh=sp_mesh)


class whole_statistics:
    """Inside, an azimuth-sharded GroupNorm takes its statistics from the
    gathered activations with the one-process plain norm (the control that
    isolates the order of the statistics' sums)."""

    def __enter__(self):
        from lidarcrafter_tpu_torch.kernels.groupnorm import group_norm_plain
        from lidarcrafter_tpu_torch.parallel.mesh import azimuth

        self.saved = ops.group_norm

        def norm(x, weight, bias, *, exchange=None, **kw):
            mesh = azimuth()
            if exchange is None or mesh is None:
                return self.saved(x, weight, bias, **kw)
            whole = mesh.gather_w(x)  # NHWC: every sharded norm's input
            y = group_norm_plain(whole, weight, bias, **kw)
            return y[:, :, mesh.columns(whole.shape[2])]

        ops.group_norm = norm

    def __exit__(self, *exc):
        ops.group_norm = self.saved


def train_case(name: str, inputs: dict, mesh, out: dict) -> None:
    """One train step of the small stack (``train_batch``: x_0 and the
    conditions; the uncond discrete stack's x_0 alone) on the (2, 2) mesh
    with a loss mask, against the same step in one process: the loss (the
    mean of the ranks') and the gradients (their mean over the ranks)."""
    case = inputs[name]
    batch, mask = case["train_batch"], case["loss_mask"]

    def step(on_mesh: bool):
        mods, engine = build(case)
        opt = make_optimizer(lr=1e-3, warmup_steps=1, num_steps=10)
        captured = []

        def reduce(grads):
            if on_mesh:
                for g in grads:
                    dist.all_reduce(g)
                    g /= mesh.world
            captured.extend(g.clone() for g in grads)

        train_step = make_train_step(engine, opt, reduce_grads=reduce)
        state = TrainState.create(mods, opt)
        sharding = batch_sharding(mesh, 4, sp_axis=2)
        if not on_mesh:
            _, loss = train_step(state, batch, 0, loss_mask=mask)
            return float(loss), captured
        local = mesh.cut_batch(batch, AZIMUTH_KEYS) if isinstance(batch, dict) else sharding.cut(batch)
        rows = sharding.rows(mask.shape[0], mask.shape[2])
        with mesh.active():
            _, loss = train_step(state, local, 0, loss_mask=sharding.cut(mask), rows=rows)
        loss = loss.clone()
        dist.all_reduce(loss)
        return float(loss) / mesh.world, captured

    loss, grads = step(True)
    loss_one, grads_one = step(False)
    flat = torch.cat([g.flatten() for g in grads])
    flat_one = torch.cat([g.flatten() for g in grads_one])
    out[f"train {name}"] = {"loss": loss, "loss_one": loss_one,
                            "grad_rel_l2": float((flat - flat_one).norm() / flat_one.norm()),
                            "mask_counts": [int(c) for c in mask_counts(mask, mesh)]}


def mask_counts(mask: torch.Tensor, mesh) -> list:
    """The loss mask's ones in each sp shard of sample 0."""
    W = mask.shape[2]
    return [mask[0, :, j * W // mesh.sp:(j + 1) * W // mesh.sp].sum() for j in range(mesh.sp)]


def flow_train_case(name: str, inputs: dict, mesh, out: dict) -> None:
    """One MeanFlow train step on the (2, 2) mesh with the JAX key chain's
    t, r and noise injected (each rank its rows and columns) against the
    same step in one process: the loss (the mean of the ranks') and the
    gradients (their mean over the ranks)."""
    case = inputs[name]
    x, draws = case["train_x"], case["draws"]

    def step(on_mesh: bool):
        mods, engine = build(case)
        opt = make_optimizer(lr=1e-3, warmup_steps=1, num_steps=10)
        captured = []

        def reduce(grads):
            if on_mesh:
                for g in grads:
                    dist.all_reduce(g)
                    g /= mesh.world
            captured.extend(g.clone() for g in grads)

        train_step = make_train_step(engine, opt, reduce_grads=reduce, loss_has_aux=True)
        state = TrainState.create(mods, opt)
        if not on_mesh:
            _, loss = train_step(state, x, 0, **draws)
            return float(loss), captured
        sharding, rows = batch_sharding(mesh, 4, sp_axis=2), batch_sharding(mesh, 1)
        local = {"t": rows.cut(draws["t"]), "r": rows.cut(draws["r"]), "noise": sharding.cut(draws["noise"])}
        with mesh.active():
            _, loss = train_step(state, sharding.cut(x), 0, **local)
        loss = loss.clone()
        dist.all_reduce(loss)
        return float(loss) / mesh.world, captured

    loss, grads = step(True)
    loss_one, grads_one = step(False)
    names = [f"model.{n}" for n, _ in build(case)[0]["model"].named_parameters()]
    out[f"train {name}"] = {"loss": loss, "loss_one": loss_one, "grads": dict(zip(names, grads)),
                            "grads_one": dict(zip(names, grads_one))}


def cli_losses(args: list, parallel=None) -> list:
    """The losses that ``train.main(args)`` logged (rank 0 logs under a
    group: the mean over the ranks)."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_cli.main(args, parallel=parallel)
    return [ast.literal_eval(ln)["loss"] for ln in text.getvalue().splitlines() if ln.startswith("{'step'")]


def flow_cli_case(name: str, inputs: dict, rank: int, world: int, out_dir: Path, out: dict) -> None:
    """``train.main --sp 2 --synthetic-data`` on a (2, 2) group, and on rank
    0 the same command in one process: the losses each logged."""
    args = inputs[name]["cli"]
    P = DataParallel(rank, world, torch.device("cpu"), sp=2)
    losses = cli_losses([*args, "--sp", "2", "--output-dir", str(out_dir / "cli_sp")], P)
    one = cli_losses([*args, "--output-dir", str(out_dir / "cli_one")]) if rank == 0 else None
    out[f"cli {name}"] = {"losses": losses, "losses_one": one, "mesh": (P.mesh.dp, P.mesh.sp)}


class CapturingParallel(DataParallel):
    """A ``DataParallel`` rank that keeps the averaged gradients of its last
    step."""

    def average_(self, tensors):
        super().average_(tensors)
        self.grads = [t.clone() for t in tensors]


def branch_case(name: str, inputs: dict, rank: int, world: int, out: dict) -> None:
    """One step of the branch's trainer on a (2, 2) group (each ``dp`` index
    on its scenes or objects, its ``sp`` ranks replicating them), against
    the step's loss and gradients in one process on the whole batch."""
    case = inputs[name]
    cls, cfg, seed = (LayoutTrainer if name == "nuscenes-layout" else ObjectTrainer), case["cfg"], 0
    P = CapturingParallel(rank, world, torch.device("cpu"), sp=2)
    dp = P.mesh.dp
    if cls is LayoutTrainer:
        items = synthetic_scene_graph_items(cfg.training.batch_size_train, 3, seed=6)
        n = len(items) // dp
        whole, mine = collate_scene_graphs(items), collate_scene_graphs(items[P.mesh.dp_index * n:][:n])
        kw = dict(max_nodes=32, max_edges=128)
    else:
        whole = synthetic_object_points(2, cfg.training.batch_size_train // 2, cfg.data.num_samples, seed=6)
        text = whole.pop("fg_text_features")
        n = len(whole["fg_class"]) // dp
        mine = {k: v[P.mesh.dp_index * n:][:n] for k, v in whole.items()}
        kw = dict(text_features=text)
    logs = []
    trainer = cls(cfg, iter([mine]), log_fn=logs.append, device="cpu", parallel=P, **kw)
    trainer.train(num_steps=1, seed=seed, log_every=1)
    one = cls(cfg, iter(()), log_fn=None, device="cpu", **kw)
    state = one.init_state(seed)
    prepared = one.prepare_batch(whole)
    loss_one, grads_one = loss_and_grads(one.engine, state.params(), prepared, generator=step_generator(seed, 0, "cpu"),
                                         **one._loss_kwargs())
    flat, flat_one = (torch.cat([g.flatten() for g in gs]) for gs in (P.grads, grads_one))
    losses = [r["loss"] for r in logs if "loss" in r]
    out[f"branch {name}"] = {"loss": losses[0] if losses else None, "loss_one": float(loss_one),
                             "grad_rel_l2": float((flat - flat_one).norm() / flat_one.norm()),
                             "sharded": trainer.sharded, "mesh": (P.mesh.dp, P.mesh.sp)}


def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    meshes = {2: make_mesh(sp=2), 4: make_mesh(sp=4)}  # (2, 2) and (1, 4)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    out = {"layers": {}}
    for sp, mesh in meshes.items():
        for name in LAYERS:
            out["layers"][f"{name} sp={sp}"] = run_layer(name, mesh)
    for name in inputs["stacks"]:
        stack_case(name, inputs, meshes[2], out)
    for name in inputs["train"]:
        train_case(name, inputs, meshes[2], out)
    for name in inputs["branches"]:
        branch_case(name, inputs, rank, world, out)
    for name in inputs["flow"]:
        flow_case(name, inputs, meshes[2], out)
        flow_train_case(name, inputs, meshes[2], out)
        flow_cli_case(name, inputs, rank, world, out_dir, out)
    if rank == 0:
        torch.save(copy.deepcopy(out), out_dir / "results.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
