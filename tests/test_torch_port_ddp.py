"""Data-parallel training of the port (``parallel/ddp.py``) on the CPU: two
``gloo`` processes under ``torchrun`` against one process, through the
``train`` CLI on the same nuScenes-format files and the same global batch.

(a) ``PrefetchLoader``: the rows that ranks 0 and 1 of 2 load, side by
    side, are the one-process batch, sample for sample, on the random train
    split of the autoregressive task; the ranks' ``draws.Rows`` cuts of a
    draw are the whole draw's rows.
(b) A group of one (gloo, in this process) draws what the engines draw
    themselves: one step of each branch (the reduced v6 and
    ``nuscenes-layout`` under their configured bf16 AMP, where the layout
    encoder's change noise is drawn in bf16, MeanFlow, the object branch)
    on the rank's rows gives the loss of the step without a group, bit for
    bit.
(c) The reduced ``nuscenes-box-layout-v6`` (32x128, 32 channels, three
    levels of one residual block, attention at ds 4, one encoder layer) and
    ``nuscenes-layout`` (64 channels, three levels of one residual block,
    two layers in each scene-graph GCN), both float32 (under bf16 AMP the
    gradients' row sums round differently when the rows are split), global
    batch 2, lr 1e-3 after a one-step warm-up, 2 steps.  The logged losses (the ranks' mean) equal
    the one process's to 1e-6 relative; Adam's first moments (the
    gradients, averaged over the ranks) to 1e-5 relative L2 per tensor (a
    tensor whose moment is zero up to rounding, below 1e-6 of the overall
    norm, to 1e-6 of that norm); the parameters after 2 steps to 1e-6 on
    the elements where Adam is well conditioned (the root of the second
    moment at least 1e-3 of its RMS over all elements: on the others, such
    as a conv bias right before a one-channel group norm, Adam turns
    rounding noise into a step of either sign), all within Adam's step
    bound 3·lr, at most 10% of the elements with a gradient set aside, and
    those without one (an unused embedding row) equal.  The layout run
    pads each rank to 16 of the 32 nodes of the global budget.
"""

import ast
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_harness import one_torch_thread  # noqa: F401 (one_torch_thread: autouse)

from lidarcrafter_tpu_torch import configs as tcfgs
from lidarcrafter_tpu_torch import train as train_cli
from lidarcrafter_tpu_torch.datasets import make_dataset
from lidarcrafter_tpu_torch.draws import Rows
from lidarcrafter_tpu_torch.datasets.loader import PrefetchLoader
from lidarcrafter_tpu_torch.parallel.ddp import DataParallel
from lidarcrafter_tpu_torch.training.state import named_module_params
from lidarcrafter_tpu_torch.utils.synthetic import point_config_at_tree, text_features, write_nuscenes_tree

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_nuscenes_tree(tmp_path_factory.mktemp("nusc"), num_points=4000)


def test_rank_rows_make_the_global_batch(tree):
    cfg = point_config_at_tree(tcfgs.get_config("nuscenes-auto-reg-v2"), tree)
    ds = make_dataset(cfg)
    one = iter(PrefetchLoader(ds, 4, num_workers=0, seed=2))
    ranks = [iter(PrefetchLoader(ds, 4, num_workers=2, seed=2, rank=r, world=2)) for r in (0, 1)]
    for _ in range(3):
        want = next(one)
        got = [next(r) for r in ranks]
        assert got[0]["token"] + got[1]["token"] == want["token"]
        np.testing.assert_array_equal(np.concatenate([g["autoregressive_cond"] for g in got]),
                                      want["autoregressive_cond"])
    with pytest.raises(ValueError):
        PrefetchLoader(ds, 3, world=2)


def test_rank_rows_cut_the_global_draws():
    """``draws.Rows``: the ranks' cuts of a draw are the rows of the whole
    draw, exactly, and a rank's padded rows are zeros."""
    def gen():
        return torch.Generator().manual_seed(5)

    whole = Rows.whole(6).randn(gen(), "cpu", (3,))
    assert torch.equal(torch.cat([Rows(r * 3, 3, 6).randn(gen(), "cpu", (3,)) for r in (0, 1)]), whole)
    padded = Rows(2, 2, 6, size=4).rand(gen(), "cpu")
    assert torch.equal(padded[:2], Rows.whole(6).rand(gen(), "cpu")[2:4]) and not padded[2:].any()
    assert DataParallel(1, 2, torch.device("cpu")).rows(3) == Rows(3, 3, 6)


SMALL_V6 = ["--resolution", "32", "128", "--model-channels", "32", "--set", "model.params.channel_mult=[1,2,4]",
            "--set", "model.params.num_res_blocks=1", "--set", "model.params.attention_ds=[4]",
            "--set", "condition_model.params.num_layers=1", "--set", "condition_model.params.resolution_to_attention=[4]"]
SMALL_LAYOUT = ["--model-channels", "64", "--set", "model.params.channel_mult=[1,1,1]",
                "--set", "model.params.num_res_blocks=1", "--set", "condition_model.params.gconv_num_layers=2"]
WORLD_ONE = {
    "nuscenes-box-layout-v6": SMALL_V6,
    "nuscenes-layout": SMALL_LAYOUT,
    "meanflow-nusc": ["--resolution", "16", "64", "--model-channels", "16"],
    "nuscenes-object": ["--set", "data.num_samples=64"],
}


@pytest.mark.parametrize("name", list(WORLD_ONE))
def test_a_group_of_one_draws_what_the_engine_draws(tree, name):
    args = train_cli.build_parser().parse_args(["-c", name, "-b", "2", *WORLD_ONE[name]])
    cfg = point_config_at_tree(train_cli.config_from_args(args), tree)
    if name == "meanflow-nusc":
        cfg.model.params["num_residual_blocks"] = (1, 1, 1, 1)
    group = DataParallel.join(0, 1, "cpu", f"tcp://localhost:{_free_port()}")
    try:
        losses = []
        for parallel in (None, group):
            logs = []
            data = train_cli.file_batches(cfg, 0, workers=0, parallel=parallel, text_encode_fn=text_features)
            trainer = train_cli.build_trainer(cfg, 0, "cpu", data=data, log_fn=logs.append, parallel=parallel)
            trainer.train(num_steps=1, checkpoint_every=0, log_every=1)
            losses.append(logs[-1]["loss"])
    finally:
        group.leave()
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(args: list[str], out: Path, nproc: int) -> list[float]:
    """The CLI in ``nproc`` processes (``torchrun``; one without it) → the
    logged losses; the checkpoint of step 2 lands in ``out``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("WORLD_SIZE", None)
    launch = [sys.executable, "-m", "lidarcrafter_tpu_torch.train"]
    if nproc > 1:
        launch = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
                  "--master-addr", "localhost", "--master-port", str(_free_port()),
                  "-m", "lidarcrafter_tpu_torch.train"]
    proc = subprocess.run(launch + args + ["--output-dir", str(out)], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = [ast.literal_eval(line) for line in proc.stdout.splitlines() if line.startswith("{'step'")]
    return [r["loss"] for r in records]


CASES = {
    "nuscenes-box-layout-v6": [*SMALL_V6, "--set", 'training.mixed_precision="no"'],
    "nuscenes-layout": [*SMALL_LAYOUT, "--set", 'training.mixed_precision="no"'],
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_gloo_processes_train_like_one(tree, tmp_path, name):
    args = ["-c", name, "--device", "cpu", "-b", "2", "--num-steps", "2", "--workers", "1", "--log-every", "1",
            "--checkpoint-every", "2", "--set", f'data.data_root="{tree["data_root"]}"',
            "--set", f'data.pkl_path="{tree["pkl_path"]}"', "--set", f'data.clip_cache_dir="{tree["clip_cache_dir"]}"',
            "--set", f"training.lr={LR}", "--set", "training.lr_warmup_steps=1", *CASES[name]]
    losses = {n: _run(args, tmp_path / str(n), n) for n in (1, 2)}
    assert len(losses[1]) == len(losses[2]) == 2
    np.testing.assert_allclose(losses[2], losses[1], rtol=1e-6)
    one, two = (torch.load(tmp_path / str(n) / "ckpt_0000000002" / "state.pt", weights_only=True) for n in (1, 2))
    assert one["step"] == two["step"] == 2

    mu1, mu2, nu = one["opt_state"]["mu"], two["opt_state"]["mu"], one["opt_state"]["nu"]
    total = float(torch.sqrt(sum(m.square().sum() for m in mu1)))
    for a, b in zip(mu2, mu1, strict=True):
        limit = 1e-5 * float(b.norm()) if float(b.norm()) >= 1e-6 * total else 1e-6 * total
        assert float((a - b).norm()) <= limit

    # the optimizer's order of the trained tensors, and where they started
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(args))
    trainer = train_cli.build_trainer(cfg, 0, "cpu", data=iter(()), log_fn=None)
    start = trainer.init_state(0).params()
    names = [n for n, _ in named_module_params(trainer.models)]
    assert len(names) == len(nu)
    rms = float(torch.sqrt(sum(v.sum() for v in nu) / sum(v.numel() for v in nu)))
    kept_err, moved, set_aside, count = 0.0, 0.0, 0, 0
    for n, v, p0 in zip(names, nu, start, strict=True):
        k, p = n.split(".", 1)
        err = (two["models"][k][p] - one["models"][k][p]).abs()
        keep = v.sqrt() >= 1e-3 * rms
        assert float(err.max()) <= 3 * LR, n
        assert float(torch.where(v == 0, err, 0.0).max()) == 0.0, n
        if keep.any():
            kept_err = max(kept_err, float(err[keep].max()))
        moved = max(moved, float((one["models"][k][p] - p0.detach()).abs().max()))
        set_aside += int((~keep & (v > 0)).sum())
        count += int((v > 0).sum())
    assert kept_err <= 1e-6
    assert set_aside <= 0.1 * count
    assert moved > 0.5 * LR  # the parameters moved by about lr at the second step
