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
for a random global R.  Imports torch and the port only.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lidarcrafter_tpu_torch.models import ops  # noqa: E402
from lidarcrafter_tpu_torch.parallel.mesh import batch_sharding, make_mesh  # noqa: E402
from lidarcrafter_tpu_torch.training.factory import build_diffusion_training  # noqa: E402
from lidarcrafter_tpu_torch.training.optim import make_optimizer  # noqa: E402
from lidarcrafter_tpu_torch.training.state import TrainState  # noqa: E402
from lidarcrafter_tpu_torch.training.train_step import make_train_step  # noqa: E402

LAYER_SHAPE = (2, 8, 32, 16)  # B, H, W, C: W / 4 = 8 columns a rank at sp = 4
LAYER_DIMS = {
    "ring_pad": LAYER_SHAPE,
    "RingConv": LAYER_SHAPE,
    "Resample up": LAYER_SHAPE,
    "Resample down": LAYER_SHAPE,
    "FusedGN": LAYER_SHAPE,
    "AdaGN": LAYER_SHAPE,
    "SelfAttention2d": LAYER_SHAPE,
}


def layer(name: str) -> tuple[torch.nn.Module, callable]:
    """A seeded module and how to call it on NHWC ``x``."""
    torch.manual_seed(11)
    C = LAYER_SHAPE[-1]
    if name == "ring_pad":
        return torch.nn.Identity(), lambda m, x: ops.ring_pad(x, (2, 1, 1, 0))
    if name == "RingConv":
        m = ops.RingConv(C, 8, ring=True)
        return m, lambda m, x: m(x)
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
    raise KeyError(name)


def grads_of(module: torch.nn.Module) -> list[torch.Tensor]:
    return [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in module.parameters()]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def run_layer(name: str, mesh) -> dict:
    """The layer on this rank's columns against the layer on the whole.
    A rank's ``ring_pad`` is a window of the whole padded tensor (its
    columns and their halos), which the ranks' windows overlap: each rank
    weights its window with its own R."""
    module, call = layer(name)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(LAYER_SHAPE, generator=gen)
    cols = mesh.columns(x.shape[2])
    xs = x[:, :, cols].clone().requires_grad_()
    with mesh.active():
        y = call(module, xs)
    window = name == "ring_pad"
    if window:
        r = torch.randn((mesh.sp, *y.shape), generator=gen)
        (y * r[mesh.sp_index]).sum().backward()
        y = mesh.gather_sp(y.detach())
    else:
        r = torch.randn((*y.shape[:2], y.shape[2] * mesh.sp, y.shape[3]), generator=gen)
        (y * r[:, :, mesh.columns(r.shape[2])]).sum().backward()
        y = mesh.gather_w(y.detach())
    gx = mesh.gather_w(xs.grad)
    gp = grads_of(module)
    for g in gp:
        dist.all_reduce(g, group=mesh.sp_group)
    module.zero_grad()
    xw = x.clone().requires_grad_()
    want = call(module, xw)
    if window:
        n = x.shape[2] // mesh.sp
        want = torch.stack([want[:, :, j * n: j * n + y.shape[3]] for j in range(mesh.sp)])
    (want * r).sum().backward()
    wp = grads_of(module)
    total = float(torch.cat([w.flatten() for w in wp]).norm()) if wp else 0.0
    # per tensor, where its gradient is not zero up to rounding (an
    # attention key bias has none: a shift of every key's logit cancels)
    p_err = max((float((a - b).norm()) / float(b.norm()) for a, b in zip(gp, wp) if float(b.norm()) > 1e-6 * total),
                default=0.0)
    return {"out": rel(y, want.detach()), "grad_x": rel(gx, xw.grad), "grad_params": p_err,
            "shape": list(want.shape)}


def build(cfg, state: dict):
    models, engine, _ = build_diffusion_training(cfg, "cpu")
    mods = models if isinstance(models, dict) else {"model": models}
    for k, m in mods.items():
        m.load_state_dict(state[k])
    return mods, engine


def stack_case(name: str, inputs: dict, mesh, out: dict) -> None:
    """The small stack's forward, its DDIM@2 sample and (with the GroupNorm
    statistics taken from the gathered activations: every op but the
    statistics exactly as in one process) the same sample again."""
    case = inputs[name]
    mods, engine = build(case["cfg"], case["state"])
    x, t = case["x"], case["t"]
    sharding = batch_sharding(mesh, 4, sp_axis=2)
    cond = case.get("batch")
    from lidarcrafter_tpu_torch.diffusion.conditional import AZIMUTH_KEYS

    t_local = batch_sharding(mesh, 1).cut(t)
    with torch.no_grad():
        if cond is None:
            with mesh.active():
                got = engine.model(sharding.cut(x), t_local)
            want = engine.model(x, t)
        else:
            local = mesh.cut_batch(cond, AZIMUTH_KEYS)
            with mesh.active():
                layout = engine.cond_model(local)
                got = engine.model(sharding.cut(x), {"time_condition": t_local, "other_condition": layout})
            want = engine.model(x, {"time_condition": t, "other_condition": engine.cond_model(cond)})
    got = sharding.gather(got)
    # the samples on this rank's sp group alone, the whole batch on each:
    # the control is bit for bit only where every op sees one process's
    # batch (a convolution of one row and of two may round apart)
    x_T, sp_mesh = case["x_T"], mesh.sp_only()
    args = () if cond is None else (cond,)
    local_args = () if cond is None else (sp_mesh.cut_batch(cond, AZIMUTH_KEYS),)
    sample = engine.sample(*local_args, x_T.shape[0], 2, mode="ddim", x_T=x_T, mesh=sp_mesh)
    sample_one = engine.sample(*args, x_T.shape[0], 2, mode="ddim", x_T=x_T)
    with whole_statistics():
        sample_whole_stats = engine.sample(*local_args, x_T.shape[0], 2, mode="ddim", x_T=x_T, mesh=sp_mesh)
    out[name] = {"forward": got, "forward_one": want, "sample": sample, "sample_one": sample_one,
                 "sample_whole_stats": sample_whole_stats}


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


def train_case(inputs: dict, mesh, out: dict) -> None:
    """One train step of the small auto-reg-v2 stack on the (2, 2) mesh with
    a loss mask, against the same step in one process."""
    case = inputs["nuscenes-auto-reg-v2"]
    batch, mask = case["train_batch"], case["loss_mask"]
    from lidarcrafter_tpu_torch.diffusion.conditional import AZIMUTH_KEYS

    def step(on_mesh: bool):
        mods, engine = build(case["cfg"], case["state"])
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
        local = mesh.cut_batch(batch, AZIMUTH_KEYS)
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
    out["train"] = {"loss": loss, "loss_one": loss_one,
                    "grad_rel_l2": float((flat - flat_one).norm() / flat_one.norm()),
                    "mask_counts": [int(c) for c in mask_counts(mask, mesh)]}


def mask_counts(mask: torch.Tensor, mesh) -> list:
    """The loss mask's ones in each sp shard of sample 0."""
    W = mask.shape[2]
    return [mask[0, :, j * W // mesh.sp:(j + 1) * W // mesh.sp].sum() for j in range(mesh.sp)]


def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    meshes = {2: make_mesh(sp=2), 4: make_mesh(sp=4)}  # (2, 2) and (1, 4)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    out = {"layers": {}}
    for sp, mesh in meshes.items():
        for name in LAYER_DIMS:
            out["layers"][f"{name} sp={sp}"] = run_layer(name, mesh)
    for name in ("nuscenes-unet-uncond", "nuscenes-auto-reg-v2"):
        stack_case(name, inputs, meshes[2], out)
    train_case(inputs, meshes[2], out)
    if rank == 0:
        torch.save(copy.deepcopy(out), out_dir / "results.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
