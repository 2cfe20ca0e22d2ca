#!/usr/bin/env python3
"""Run the PyTorch port (``lidarcrafter_tpu_torch``) on one NVIDIA GPU and
check it; the quickest proof that the port still builds and starts there.

Phases, each printing one JSON line:

1. device and build: the card's name and power limit, the ``nvcc`` build of
   ``lidarcrafter_tpu_torch/csrc/*.cu`` (four sources, one ``nvcc`` each, in
   parallel) and the loader's ``x·2`` self-check, with the probe kernel's
   device time beside its bound and ``torch.mul(x, 2)``;
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged / masked edges, in float32 (TF32 off) and
   bfloat16, held to a limit on the largest error and one on the error's
   norm, with the kernel's, the plain version's and one PyTorch library
   call's device times, the least time the card could take (no row may
   read below it), and the route each runs (``mma 3xTF32`` / ``mma bf16``
   tensor cores for OACA and attention; GroupNorm on the CUDA cores as
   ``one-launch grid-sync``: one launch per norm, at most one block per SM
   with a grid sync, fed the modules' raw operands: weight, bias and the
   strided scale/shift halves of the conditioning projection), and
   GroupNorm at the layout branch's UNet1D token shapes, (104, 1, 512) and
   (104, 1, 1024) with eps 1e-5 and (104, 1, 512) with eps 1e-6, float32
   (as the branch serves) and bfloat16 (as it trains under AMP); and the
   shapes of phase 11: OACA at head dims 64 (the v0 stack, ds4 L=2048 and a
   ragged L=1000, 8 heads), GroupNorm on v0's (8, 32·1024, 256) and
   (8, 32·1024, 512) slabs and kitti-360's (8, 64·1024, 64) AdaGN, and
   attention at kitti-360's 1,024 tokens (head dims 64 and 32);
3. full-width forwards on the card with the kernels against the same
   forwards on the CPU with the plain versions, shared seeded weights: the
   layout stack (encoder + ``LayoutUnetV1``, 32x1024) and ``EfficientUNet``
   (``nuscenes-unet-uncond``, 32x1024), in float32 and served in bfloat16
   (``to_serving_dtype_`` and the engine's ``dtype``);
4. the main paths, each with the launch counters set to 0 just before it
   and read just after, seeded random weights, 8 frames a request:
   ``CondFrameGenerator`` for ``nuscenes-box-layout-v6`` and
   ``UncondFrameGenerator`` for ``nuscenes-unet-uncond`` (DDIM@50 and
   DPM-Solver++(2M)@15 each), then ``FlowFrameGenerator`` for
   ``meanflow-nusc`` (one step), all in float32; then each path served in
   bfloat16 answers one request (DPM-Solver++(2M)@15, MeanFlow one step);
5. a ``torch.profiler`` trace of one denoiser call of the layout and of the
   unconditional path (after one warm-up cycle of the trace, and queued
   behind a ~20 ms sleep: the trace drops the kernels of its first
   milliseconds), in float32 and in bfloat16: device time by kernel
   category, the device kernels launched per call and the device's idle
   share; the ``groupnorm kernel`` category must hold exactly one device
   kernel per norm (101 a layout call, 50 an uncond call): a trace with
   more fails, one with fewer is taken again, up to three traces, each
   reported;
6. the 4D rollout, in float32 and then served in bfloat16:
   ``RolloutGenerator`` (``nuscenes-box-layout-v6`` frame 0,
   ``nuscenes-auto-reg-v2`` after it) rolls 8 synthetic scenes of 4 boxes
   1 + 15 frames with DPM-Solver++(2M)@15, after one short warm-up, with
   the launch counters set to 0 just before and read just after: rollout
   seconds and frames/s, the geometry step's device time per frame and the
   denoiser calls' (CUDA events around each), peak memory; checks 16 finite,
   non-constant (8, 32, 1024, 2) frames, exactly 11·15·16 OACA and
   101·15·16 GroupNorm launches, and one frame's geometry step on the card
   against the CPU from the same frame (condition maps equal to 1e-5 on at
   least 99.9% of the pixels; the rest are bin-edge flips);
7. training ("train"): (a) each kernel route's backward (the float32
   recompute of its plain version) on the card against autograd through the
   plain version, float32 and bfloat16, at the largest main-path shapes, to
   the forward rows' limits, timed beside the library's forward + backward
   (SDPA with the layout strip concatenated; ``F.group_norm`` with affine
   only); (b) one full-width ``nuscenes-box-layout-v6`` step at B=1 in
   float32, card (kernels) against CPU (plain), same weights, x_0, t, noise
   and conditions: loss to 1e-4 relative, every gradient to 1e-3 relative
   L2; (c) ``Trainer`` on ``nuscenes-box-layout-v6`` and
   ``nuscenes-unet-uncond`` at B=8, float32 and bf16 AMP, 3 warm-up and 10
   timed steps: steps/s, frames/s, peak memory, and exactly 11 OACA + 101
   GroupNorm launches a layout step, 2 attention + 50 GroupNorm an uncond
   step; (d) ``nuscenes-auto-reg-v2`` at full width, B=2, float32, 100
   steps on banded synthetic range images (lr 1e-4, warm-up 20): the mean
   of the last 10 losses must lie below that of the first 10; (e) its
   checkpoint read back through ``sample_temporal``'s ``--autoreg-ckpt``
   loader, EMA weights equal bit for bit, and one DPM-Solver++(2M)@15 frame
   sampled from them, finite;
8. the layout and object branches, float32 at their published widths:
   (a) ``LayoutGenerator`` (``nuscenes-layout``) on 8 synthetic scene
   graphs of ego + 12 objects (N = 104 nodes): the ``SceneGraph`` latent
   and one denoiser call (``SceneGraph`` + ``UNet1DModel``) on the card
   against the CPU to 1e-3, exactly 56 GroupNorm launches in that call and
   56 GroupNorm device kernels in a profiled one (device busy, idle
   share), then a DDPM@256 and a DDIM@50 request with the counters set to
   0 just before and read just after (56 a denoiser call): seconds, ms a
   call, finite samples, and finite centres, yaw and trajectories after
   ``unscale_boxes_3d`` (the share of finite sizes is reported: an
   untrained denoiser's unclipped x̂_0 can overflow exp(log size));
   (b) ``ObjectGenerator`` (``nuscenes-object``) on the 96 objects of those
   scenes × 1024 points: one call card vs CPU to 1e-3, a profile, both
   requests, finite clouds; no kernel of the port runs there, and every
   launch counter must stay at 0;
9. branch training ("branch_train"): (a) the forward-mode routes of the
   attention (``d_block4``, ``u_block4``) and GroupNorm (the uncond level-0
   AdaGN, ds8) kernels under ``torch.func.jvp`` and ``forward_ad``, float32
   and bfloat16, one kernel launch a call, primal and tangent against
   ``torch.func.jvp`` through the plain version to the forward rows'
   limits, timed beside that plain jvp and the least time the card could
   take; (b) one full-width float32 step of ``LayoutTrainer``
   (``nuscenes-layout``, 8 scenes of ego + 12, budgets 112 / 3,536),
   ``ObjectTrainer`` (``nuscenes-object``, 96 objects × 1024 points) and
   ``FlowTrainer`` (``meanflow-nusc``, the MeanFlow JVP loss, B=2), card
   against CPU on the same weights, batch and draws: loss to 1e-4
   relative, every gradient to 1e-3 relative L2; (c) each trainer at B=8 (8
   scenes for the layout), float32 and bf16 AMP, as phase 7 (c), with
   exactly 56 GroupNorm launches a layout step, 2 attention + 50 GroupNorm
   a MeanFlow step and none an object step; (d) a 100-step loss gate of
   each (lr 1e-4, warm-up 20; 8 scenes, 96 objects, MeanFlow at B=2) and
   its checkpoint served
   through the branch's generator (EMA weights and running statistics bit
   for bit, finite samples);
10. the metric suite ("evaluate") over phase 6's float32 rollout as host
   clouds (scenes 0-3 "real", 4-7 "gen", 64 clouds each), with a RangeNet-53
   (32x1024, 4,096 features) and a PointNet (k=16, 2,048 points) of seeded
   weights: ``EvaluationEngine`` (frd, fpd and their squared MMDs, BEV jsd
   and mmd), ``evaluate`` (cd and the chamfer mmd on 8 aligned pairs, emd
   on them resampled to 2,048 points, jsd, and frid through a pretrained
   folder written from the RangeNet-53), ``sequence_tcd`` (splits 1-4) of
   each scene, and ICP recovering a 3° / (1.0, 0.5, 0) m motion of a frame
   to 0.05 m; every metric again through the port on the CPU (the engine's
   from the card's cached features; cd, mmd and TCD on clouds resampled to
   2,048 points on both sides, as a CPU chamfer grows with N²; the features
   and FRID descriptors of 8 clouds turned half a pixel, off the bin edges
   their points lie on), held to 1e-4 relative (cd, jsd, mmd, TCD), 1e-3
   (Fréchet distances in float64, emd) and 1e-3 relative L2 (features);
   device times of the RangeNet-53 / PointNet features and the BEV histogram
   a cloud, one chamfer at 32,768², one EMD at 26,624 points, the Fréchet
   distance and squared MMD of 2,000 x 4,096 features, peak memory; no
   kernel of the port launches;
11. the rest of the registry's image configs ("zoo"), at full width, seeded
   random weights: ``nuscenes-box-layout`` (v0: ``LayoutUnet``, OACA at
   head dims 64, 6 a call), ``nuscenes-box-layout-v5`` (served from a
   batch with the v5 encoder's inputs), ``nuscenes-auto-reg`` (12 encoder
   channels), ``kitti-360`` (64x1024) and ``nuscenes-hdit-uncond`` (HDiT,
   plain PyTorch): one forward card vs CPU as phase 3 (f32 1e-3, bf16
   5e-2; HDiT's bf16 call against the CPU's bf16 call, since its serving
   cast rounds the Fourier time features as the JAX package's does, and
   its gap to float32 reported), then one B=8 DPM++(2M)@15 request each
   in float32 and in bfloat16 through ``CondFrameGenerator`` /
   ``UncondFrameGenerator``, the counters set to 0 just before and read
   just after (exactly one OACA per ``ObjectAwareCrossAttention``, one
   attention per attention block, one GroupNorm per norm module, a call;
   HDiT none), with seconds, frames/s and peak memory; a profile of one
   v0 and one HDiT call; then on ``nuscenes-unet-uncond`` one RePaint
   request (10 steps x 2 resamplings x jump 2, every other beam known:
   the known beams held to (1 − α(0)) + 6·σ(0)) and one
   ``DiscreteDiffusion`` DDPM@50 request (1,000 training steps, set on
   the config: the registry leaves them unset).

Then a ``kernels`` JSON line, the ``nvidia-smi`` name/power-limit line and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; so does a machine without CUDA or a directory without
the port.

Usage: ``python3 chip_smoke.py`` (one card).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# peak rate of each route's operations: GroupNorm ("one-launch grid-sync") in
# f32 on the CUDA cores (bf16 is widened on load); OACA and attention on the
# tensor cores, f32 as 3xTF32 (three TF32 products each)
GN_ROUTE = "one-launch grid-sync"
# the routes' backward and tangent: the plain version recomputed in float32
# (TF32 off); their bound is the same work at the peak of the operands' type
# (work_route), not that of the recompute
PLAIN_ROUTE = "plain f32 recompute"
PEAK_FLOPS = {GN_ROUTE: 67e12, "mma 3xTF32": 495e12 / 3, "mma bf16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel − plain| / max(1, max |plain|)
# ‖kernel − plain‖₂ / ‖plain‖₂: attention outputs average thousands of keys
# and are mostly far below 1, where the max-based limit is as large as a
# typical value; this one catches a fault on a few percent of the keys (a
# missed key tile, a missed fill).  A correct kernel reads about 2^-9 in
# bfloat16 (one rounding of the output) and 1e-5 or less in float32.
NORM_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
FORWARD_RTOL = 1e-3  # card (kernels, cuDNN f32) vs CPU (plain), relative to max |CPU|
# card served in bfloat16 vs CPU float32, relative to max |CPU|: bfloat16 keeps
# 8 mantissa bits (2^-9 relative per rounding) through ~40-60 layers
BF16_FORWARD_RTOL = 5e-2
OACA_PER_FORWARD, GN_PER_FORWARD = 11, 101  # layout UNet, per denoiser call
ATTN_PER_UNET, GN_PER_UNET = 2, 50  # EfficientUNet / MFEfficientUNet, per call
REQUESTS = (("ddim", 50), ("dpmpp_2m", 15))
BATCH = 8
ROLLOUT_SCENES, ROLLOUT_FRAMES, ROLLOUT_STEPS = 8, 15, 15  # 1 + 15 frames, DPM++(2M)@15
GEOMETRY_RTOL, GEOMETRY_PIXEL_SHARE = 1e-5, 0.999  # card vs CPU condition maps
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3  # one v6 step, card vs CPU
TRAIN_WARMUP, TRAIN_TIMED = 3, 10  # steps of the B=8 training runs
GATE_STEPS, GATE_BATCH = 100, 2  # nuscenes-auto-reg-v2 on banded range images
# the layout and object branches: 8 scenes of ego + 12 objects (13 nodes, the
# frame stack's layout_length; N = 104), and the 96 objects of those scenes
LAYOUT_SCENES, LAYOUT_OBJECTS = 8, 12
BRANCH_REQUESTS = (("ddpm", 256), ("ddim", 50))  # DDPM@256 is the JAX tools' default
GN_PER_UNET1D = 56  # 22 ResBlock1D x 2, 11 SpatialTransformer1Token, the output norm
# a profiled call is queued behind a sleep of ~20 ms (4e7 cycles) and traced
# again while a category holds fewer kernels than expected (see phase_profile)
TRACE_SLEEP_CYCLES, TRACE_ATTEMPTS = int(4e7), 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, sleep_cycles: int = int(5e7), gc_off: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  The
    card sleeps first (5e7 cycles, ~30 ms at the H100's clock) while the
    host queues the calls, so launch-bound calls are timed on the device
    and not at the host's enqueue rate.  With ``gc_off`` (the kernel rows)
    Python's garbage collector runs once before and is off while the host
    queues, since a collection pause there longer than the sleep would read
    as the kernel's device time (late in a whole run a 0.8 ms jvp row read
    20–38 ms with it on).  End-to-end times (a denoiser call, a train step,
    a geometry step) pass ``gc_off=False``: a real call pays for its
    collections."""
    import gc

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if gc_off:
        gc.collect()
        gc.disable()
    try:
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    finally:
        if gc_off:
            gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: float, route: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[route] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mma_route(dname: str) -> str:
    """The tensor-core route of the OACA and attention kernels."""
    return "mma 3xTF32" if dname == "float32" else "mma bf16"


def work_route(kernel: str, dname: str) -> str:
    """The route whose peak bounds a kernel's work on ``dname`` operands,
    forward, backward or tangent: the tensor cores for OACA and attention
    (their backward and tangent are matrix products too), the CUDA cores
    for GroupNorm."""
    return GN_ROUTE if kernel.startswith("groupnorm") else mma_route(dname)


def max_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1.0, float(want.float().abs().max()))


def kernel_errors(what: str, dname: str, got, want) -> dict:
    """The kernel's output against its plain version on both measures, each
    checked against its limit; the row's error fields."""
    err, rel = max_err(got, want)
    diff = float((got.float() - want.float()).norm())
    norm_rel = diff / float(want.float().norm())
    check(rel <= TOL[dname], f"{what} {dname}: relative error {rel:.3g} > {TOL[dname]}")
    check(norm_rel <= NORM_TOL[dname], f"{what} {dname}: norm-relative error {norm_rel:.3g} > {NORM_TOL[dname]}")
    return {"max_abs_err": err, "rel_err": rel, "tol": TOL[dname],
            "norm_rel_err": norm_rel, "norm_tol": NORM_TOL[dname]}


def reset_counters() -> dict:
    """Every kernel's launch counter, set to 0."""
    from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

    counters = {"oaca": oaca.launches, "groupnorm": groupnorm.launches, "attention": attention.launches}
    for c in counters.values():
        c.n = 0
    return counters


# ------------------------------------------------------------------ phase 2


def oaca_operands(B, H, L, L2, dtype, gen, d=32):
    """Operands laid out as the attention block produces them: per-head
    views of one fused qkv projection, a positional strip, a small layout
    strip; head dims (d, d, d)."""
    import torch

    C = H * d
    dev = DEVICE
    qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev).to(dtype)
    heads = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)  # noqa: E731
    q_c, k_c, v_c = (heads(t) for t in qkv.chunk(3, dim=-1))
    ipe = heads(torch.randn(B, L, C, generator=gen, device=dev).to(dtype))
    k_l = torch.randn(B, H, L2, 2 * d, generator=gen, device=dev).to(dtype)
    v_l = heads(torch.randn(B, L2, 2 * C, generator=gen, device=dev).to(dtype).chunk(2, -1)[1])
    return q_c, ipe, k_c, k_l, v_c, v_l


def check_oaca(label, B, H, L, dtype, gen, d=32):
    """One OACA row at head dims (d, d, d): 32 for the v1-v6 and auto-reg
    stacks, 64 for the v0 stack."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import oaca

    L2 = 13
    ops = oaca_operands(B, H, L, L2, dtype, gen, d)
    scale = 1.0 / math.sqrt(math.sqrt(2 * d))
    got = oaca.oaca_attention(*ops, scale=scale)
    want = oaca.oaca_attention_plain(*ops, scale=scale)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"oaca {label}", dname, got, want)
    q_c, ipe, k_c, k_l, v_c, v_l = ops
    q_img = torch.cat([q_c, ipe], -1)
    k_mix = torch.cat([torch.cat([k_c, ipe], -1), k_l], 2)
    v_mix = torch.cat([v_c, v_l], 2)
    library = time_ms(lambda: F.scaled_dot_product_attention(q_img, k_mix, v_mix, scale=scale ** 2))
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (4 * B * H * L * d + B * H * L2 * 3 * d + B * H * L * d)
    flops = 2.0 * B * H * L * (L + L2) * 3 * d
    bound, by = bound_ms(nbytes, flops, mma_route(dname))
    return {
        "kernel": "oaca", "shape": label, "dtype": dname, "head_dims": [d, d, d], "route": mma_route(dname),
        **errors,
        "ms": time_ms(lambda: oaca.oaca_attention(*ops, scale=scale)),
        "plain_ms": time_ms(lambda: oaca.oaca_attention_plain(*ops, scale=scale), iters=5),
        "library_ms": library, "library": "F.scaled_dot_product_attention on the concatenated strips",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def check_groupnorm(label, shape, dtype, scale_shift, silu, gen, groups=32, eps=1e-5, affine=True):
    """The operands as the modules pass them: the norm's (C,) weight and bias
    (none for AdaGN) and the ``chunk`` halves of a (B, 2C) projection as
    scale and shift, all in the serving dtype."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import groupnorm

    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 1).to(dtype)
    w = b = s = t = None
    if affine:
        w = (1 + 0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
        b = (0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
    if scale_shift:
        s, t = (0.3 * torch.randn(B, 2 * C, generator=gen, device=DEVICE)).to(dtype).chunk(2, dim=-1)
    args = dict(num_groups=groups, eps=eps, scale=s, shift=t, silu=silu)
    got = groupnorm.group_norm(x, w, b, **args)
    want = groupnorm.group_norm_plain(x, w, b, **args)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"groupnorm {label}", dname, got, want)
    x_nchw = x.reshape(B, -1, 1, C).permute(0, 3, 1, 2)
    library = time_ms(lambda: F.group_norm(x_nchw, groups, w, b, eps))
    elt = torch.finfo(dtype).bits // 8
    # x read and y written once; weight and bias (C,), scale and shift (B, C)
    nbytes = elt * (2 * x.numel() + 2 * C * affine + 2 * B * C * scale_shift)
    bound, by = bound_ms(nbytes, 10.0 * x.numel(), GN_ROUTE)
    HW = x.numel() // (B * C)
    plan = groupnorm.plan(B, HW, C, groups, elt, torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "kernel": "groupnorm", "shape": label, "dtype": dname, "route": GN_ROUTE,
        "groups": groups, "scale_shift": scale_shift, "silu": silu, "affine": affine, **errors,
        "ms": time_ms(lambda: groupnorm.group_norm(x, w, b, **args)),
        "plain_ms": time_ms(lambda: groupnorm.group_norm_plain(x, w, b, **args)),
        "library_ms": library, "library": "F.group_norm (affine only, no scale-shift or SiLU)",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "blocks_per_image": plan.k, "grid_sync": plan.k > 1,
        "staged_rows_share": plan.stage_rows / plan.rows_per_block,
    }


def check_attention(label, B, H, Lq, Lkv, d, dtype, gen, kv_len=None):
    """q, k, v as strided per-head views of one (B, L, 3C) projection, as
    ``SelfAttention2d`` produces them (Lq == Lkv), else separate strips."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention

    C = H * d
    heads = lambda t: t.reshape(B, t.shape[1], H, d).transpose(1, 2)  # noqa: E731
    if Lq == Lkv:
        qkv = torch.randn(B, Lq, 3 * C, generator=gen, device=DEVICE).to(dtype)
        q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    else:
        q = heads(torch.randn(B, Lq, C, generator=gen, device=DEVICE).to(dtype))
        k, v = (heads(torch.randn(B, Lkv, C, generator=gen, device=DEVICE).to(dtype)) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    args = dict(scale=scale, kv_len=kv_len)
    got = attention.attention(q, k, v, **args)
    want = attention.attention_plain(q, k, v, **args)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"attention {label}", dname, got, want)
    n = Lkv if kv_len is None else kv_len
    mask = None if kv_len is None else (torch.arange(Lkv, device=DEVICE) < kv_len).expand(Lq, Lkv)
    library = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * B * H * (2 * Lq * d + 2 * n * d)
    flops = 4.0 * B * H * Lq * n * d
    bound, by = bound_ms(nbytes, flops, mma_route(dname))
    return {
        "kernel": "attention", "shape": label, "dtype": dname, "route": mma_route(dname), **errors,
        "ms": time_ms(lambda: attention.attention(q, k, v, **args)),
        "plain_ms": time_ms(lambda: attention.attention_plain(q, k, v, **args), iters=5),
        "library_ms": library, "library": "F.scaled_dot_product_attention",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def phase_kernels():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_oaca("ds4 B=8 h=8 L=2048", BATCH, 8, 2048, dtype, gen))
        rows.append(check_oaca("ds8 B=8 h=16 L=512", BATCH, 16, 512, dtype, gen))
        rows.append(check_oaca("ragged B=8 h=8 L=1000", BATCH, 8, 1000, dtype, gen))
        rows.append(check_groupnorm("level0 (8,32,1024,64) out_norm", (BATCH, 32, 1024, 64),
                                    dtype, True, True, gen))
        # the largest slab of the main paths: the layout decoder's first
        # level-0 block (out_0_0_res), whose in_norm sees the 192-channel concat
        rows.append(check_groupnorm("level0 (8,32,1024,192) in_norm out_0_0_res", (BATCH, 32, 1024, 192),
                                    dtype, False, True, gen))
        rows.append(check_groupnorm("ds8 (8,4,128,1024) in_norm", (BATCH, 4, 128, 1024),
                                    dtype, False, True, gen))
        rows.append(check_groupnorm("tokens (8,13,64)", (BATCH, 13, 64), dtype, False, False, gen))
        # the unconditional path: d_block4 at C=512 (dh 64), u_block4 at C=256 (dh 32)
        rows.append(check_attention("d_block4 B=8 h=8 L=512 d=64", BATCH, 8, 512, 512, 64, dtype, gen))
        rows.append(check_attention("u_block4 B=8 h=8 L=512 d=32", BATCH, 8, 512, 512, 32, dtype, gen))
        rows.append(check_attention("masked tail B=8 h=8 L=128 kv_len=77", BATCH, 8, 128, 128, 64,
                                    dtype, gen, kv_len=77))
        rows.append(check_attention("ragged B=8 h=8 L=300", BATCH, 8, 300, 300, 64, dtype, gen))
        rows.append(check_attention("masked head B=8 h=8 L=128 kv_len=9", BATCH, 8, 128, 128, 64,
                                    dtype, gen, kv_len=9))
        rows.append(check_groupnorm("unet level0 (8,32,1024,64) AdaGN scale-shift+SiLU", (BATCH, 32, 1024, 64),
                                    dtype, True, True, gen, groups=8, eps=1e-6, affine=False))
        rows.append(check_groupnorm("unet ds8 (8,4,128,512) SiLU", (BATCH, 4, 128, 512),
                                    dtype, False, True, gen, groups=8, eps=1e-6))
        # the v0 stack (nuscenes-box-layout): OACA at head dims 64 at ds4 and
        # in the middle, GroupNorm on its 256-channel level-0 slabs and the
        # 512-channel skip concats of its decoder
        rows.append(check_oaca("v0 ds4 B=8 h=8 L=2048 d=64", BATCH, 8, 2048, dtype, gen, d=64))
        rows.append(check_oaca("v0 ragged B=8 h=8 L=1000 d=64", BATCH, 8, 1000, dtype, gen, d=64))
        rows.append(check_groupnorm("v0 level0 (8,32,1024,256) out_norm scale-shift+SiLU", (BATCH, 32, 1024, 256),
                                    dtype, True, True, gen))
        rows.append(check_groupnorm("v0 level0 (8,32,1024,512) in_norm skip concat", (BATCH, 32, 1024, 512),
                                    dtype, False, True, gen))
        # kitti-360 (64x1024 through EfficientUNet): the level-0 AdaGN and
        # the attention of d_block4 / u_block4 at 1,024 tokens
        rows.append(check_groupnorm("kitti-360 level0 (8,64,1024,64) AdaGN scale-shift+SiLU",
                                    (BATCH, 64, 1024, 64), dtype, True, True, gen, groups=8, eps=1e-6,
                                    affine=False))
        rows.append(check_attention("kitti-360 d_block4 B=8 h=8 L=1024 d=64", BATCH, 8, 1024, 1024, 64, dtype, gen))
        rows.append(check_attention("kitti-360 u_block4 B=8 h=8 L=1024 d=32", BATCH, 8, 1024, 1024, 32, dtype, gen))
    # the layout branch's UNet1D norms: N = 104 one-row images; float32 as the
    # branch serves, bfloat16 as it trains under AMP
    N = LAYOUT_SCENES * (LAYOUT_OBJECTS + 1)
    for dtype in (torch.float32, torch.bfloat16):
        for label, C, eps, silu in ((f"tokens ({N},1,512) UNet1D res-block norm + SiLU", 512, 1e-5, True),
                                    (f"tokens ({N},1,1024) UNet1D skip-concat norm + SiLU", 1024, 1e-5, True),
                                    (f"tokens ({N},1,512) UNet1D transformer norm eps 1e-6", 512, 1e-6, False)):
            rows.append(check_groupnorm(label, (N, 1, C), dtype, False, silu, gen, eps=eps))
    for row in rows:
        emit({"phase": "kernels", **row})
        check(row["ms"] >= row["bound_ms"],
              f"{row['kernel']} {row['shape']} {row['dtype']}: {row['ms']} ms below its bound {row['bound_ms']} ms")
    return rows


# ------------------------------------------------------------------ phase 3


def check_forward(what: str, got, want, tol: float, **extra) -> None:
    """``got`` (card) against ``want`` (CPU; float32 unless ``what`` says
    otherwise) to ``tol`` of max |want|; emits the forward_parity line."""
    import torch

    err, _ = max_err(got, want)
    scale = float(want.abs().max())
    rel = err / scale
    check(got.dtype == torch.float32, f"{what}: output dtype {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{what}: not finite on the card")
    check(scale > 1e-2, f"{what}: output is (near) zero")
    check(rel <= tol, f"{what}: relative error {rel:.3g} > {tol}")
    emit({"phase": "forward_parity", "what": what, "shape": list(got.shape),
          "max_abs_err": err, "rel_err": rel, "tol": tol, **extra})


def phase_forward_parity(cfg_name: str):
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training
    from lidarcrafter_tpu_torch.weights import init_random_

    cfg = get_config(cfg_name)
    models, engine, _ = build_diffusion_training(cfg, "cpu")
    init_random_(models["cond"], 10)
    init_random_(models["model"], 11)
    B, (H, W) = 2, cfg.data.resolution
    gen = torch.Generator().manual_seed(12)
    batch = condition_batch(cfg, B, gen)
    x = torch.randn(B, H, W, 2, generator=gen)
    t = torch.tensor([-3.0, 5.0])

    def forward(cond_model, model, device):
        with torch.inference_mode():
            b = {k: v.to(device) for k, v in batch.items()}
            layout = cond_model(b)
            return model(x.to(device), {"time_condition": t.to(device), "other_condition": layout})

    t0 = time.perf_counter()
    want = forward(models["cond"], models["model"], "cpu")
    cpu_s = time.perf_counter() - t0
    gpu = {k: copy.deepcopy(m).to(DEVICE) for k, m in models.items()}
    got = forward(gpu["cond"], gpu["model"], DEVICE).cpu()
    check_forward(f"{cfg_name} float32", got, want, FORWARD_RTOL, cpu_seconds=cpu_s)
    # served in bfloat16 through the engine's own cast, against the same CPU forward
    to_serving_dtype_(gpu["model"], torch.bfloat16, cond_model=gpu["cond"])
    served = dataclasses.replace(engine, model=gpu["model"], cond_model=gpu["cond"], dtype=torch.bfloat16)
    with torch.inference_mode():
        cond = served.get_network_condition({k: v.to(DEVICE) for k, v in batch.items()})
        got = served.denoise(x.to(DEVICE), t.to(DEVICE), cond).cpu()
    check_forward(f"{cfg_name} bfloat16", got, want, BF16_FORWARD_RTOL)


def condition_batch(cfg, batch_size: int, generator, device="cpu") -> dict:
    """``layout_condition_batch`` drawn from ``generator``, with the v5
    encoder's ``fg_encoding_box`` (B, L, 8) in [-1, 1] and a (9, 512)
    ``fg_text_features`` table of 0.05·normal."""
    import torch

    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch

    batch = layout_condition_batch(cfg, batch_size, generator=generator, device=device)
    if cfg.condition_model.architecture == "layout_encoder_v5":
        L = cfg.condition_model.params["layout_length"]
        batch["fg_encoding_box"] = torch.rand((batch_size, L, 8), generator=generator, device=device) * 2 - 1
        batch["fg_text_features"] = 0.05 * torch.randn((9, 512), generator=generator, device=device)
    return batch


def phase_unet_forward_parity(cfg_name: str):
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training
    from lidarcrafter_tpu_torch.weights import init_random_

    cfg = get_config(cfg_name)
    model, engine, _ = build_diffusion_training(cfg, "cpu")
    init_random_(model, 13)
    B, (H, W) = 2, cfg.data.resolution
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(B, H, W, 2, generator=gen)
    t = torch.tensor([-3.0, 5.0])  # log-SNR, as the sampler passes it
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model(x, t)
        cpu_s = time.perf_counter() - t0
        gpu = copy.deepcopy(model).to(DEVICE)
        got = gpu(x.to(DEVICE), t.to(DEVICE)).cpu()
        check_forward(f"{cfg_name} float32", got, want, FORWARD_RTOL, cpu_seconds=cpu_s)
        # served in bfloat16 through the engine's own cast, against the same CPU forward
        to_serving_dtype_(gpu, torch.bfloat16)
        served = dataclasses.replace(engine, model=gpu, dtype=torch.bfloat16)
        got = served.denoise(x.to(DEVICE), t.to(DEVICE)).cpu()
        if cfg.model.architecture == "hdit":
            # HDiT's serving cast rounds rff_freqs and with them the Fourier
            # angles to bfloat16, as the JAX package's does, which moves the
            # output far from the float32 one (ROADMAP Queue 3 item 11): the
            # card is held to the same bfloat16 call on the CPU, and the gap
            # reported
            cpu = copy.deepcopy(model)
            to_serving_dtype_(cpu, torch.bfloat16)
            ref = dataclasses.replace(engine, model=cpu, dtype=torch.bfloat16).denoise(x, t)
            check_forward(f"{cfg_name} bfloat16 vs CPU bfloat16", got, ref, BF16_FORWARD_RTOL,
                          bf16_vs_float32_rel_err=float((got - want).abs().max() / want.abs().max()))
            return
    check_forward(f"{cfg_name} bfloat16", got, want, BF16_FORWARD_RTOL)


# ------------------------------------------------------------------ phase 4


def check_sample(sample, post, mode, shape):
    import torch

    B, H, W = shape
    check(tuple(sample.shape) == (B, H, W, 2), f"{mode} sample shape {tuple(sample.shape)}")
    check(bool(torch.isfinite(sample).all()), f"{mode} sample is not finite")
    check(tuple(post["xyz"].shape) == (B, H, W, 3), f"{mode} xyz shape")
    check(bool(torch.isfinite(post["xyz"]).all()), f"{mode} xyz is not finite")
    check(float(sample.std()) > 1e-3, f"{mode} sample is constant")
    if mode == "meanflow":
        check(float(sample.abs().max()) <= 1.0, "meanflow sample is not clamped to [-1, 1]")


def build_generators(dtype):
    """The three main paths' generators on the card, seeded random weights,
    served in ``dtype``, with their kernel-bearing modules counted."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
    from lidarcrafter_tpu_torch.models.ops import FusedGN, GroupNorm32, MFSelfAttention2d, SelfAttention2d

    def count(model, cls):
        return sum(isinstance(m, cls) for m in model.modules())

    gens = {
        "nuscenes-box-layout-v6": CondFrameGenerator(get_config("nuscenes-box-layout-v6"), DEVICE, 0, dtype),
        "nuscenes-unet-uncond": UncondFrameGenerator(get_config("nuscenes-unet-uncond"), DEVICE, 0, dtype),
        "meanflow-nusc": FlowFrameGenerator(get_config("meanflow-nusc"), DEVICE, 0, dtype),
    }
    n = count(gens["nuscenes-box-layout-v6"].models["model"], GroupNorm32)
    check(n == GN_PER_FORWARD, f"{n} GroupNorm32 modules, expected {GN_PER_FORWARD}")
    for name, attn_cls in (("nuscenes-unet-uncond", SelfAttention2d), ("meanflow-nusc", MFSelfAttention2d)):
        got = (count(gens[name].model, attn_cls), count(gens[name].model, FusedGN))
        check(got == (ATTN_PER_UNET, GN_PER_UNET),
              f"{name}: {got} attention / FusedGN modules, expected {(ATTN_PER_UNET, GN_PER_UNET)}")
    return gens


def phase_main_path(cfg_name: str, gen, per_call: dict, requests, smi: str) -> dict:
    """Answer ``requests`` ((mode, steps) pairs of 8 frames; mode
    ``meanflow`` is one step) after one warm-up, with every launch counter
    set to 0 just before and read just after; each kernel must have launched
    exactly ``per_call[kernel]`` times per denoiser call (0 if absent), in
    either serving dtype.  Returns the path's non-zero launch counts."""
    import torch

    def request(mode, steps, seed):
        if mode == "meanflow":
            return gen.generate(BATCH, seed=seed)
        return gen.generate(BATCH, steps, mode=mode, seed=seed)

    request(requests[0][0], 2, 99)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = reset_counters()
    results = []
    for i, (mode, steps) in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample, post = request(mode, steps, i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_sample(sample, post, mode, (BATCH, *gen.cfg.data.resolution))
        results.append({"mode": mode, "steps": steps, "batch": BATCH, "seconds": seconds,
                        "frames_per_s": BATCH / seconds, "sample_std": float(sample.std()),
                        "valid_depth_share": float((post["depth"] > 0).float().mean())})
    launches = {k: c.n for k, c in counters.items()}
    total_steps = sum(s for _, s in requests)
    for k, n in launches.items():
        want = per_call.get(k, 0) * total_steps
        check(n == want, f"{cfg_name}: {k} launches {n} != {per_call.get(k, 0)} x {total_steps}")
    emit({"phase": "main_path", "config": cfg_name, "dtype": str(gen.engine.dtype).split(".")[-1],
          "requests": results, "launches": launches, "card": smi,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {k: n for k, n in launches.items() if n}


def _category(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "oaca" in name:
        return "oaca kernel"
    if "attention_fwd" in name:
        return "attention kernel"
    if "gn_fused" in name:
        return "groupnorm kernel"
    if any(k in name for k in ("conv", "fprop", "winograd", "implicit", "dgrad", "cudnn")):
        return "convolution (cuDNN)"
    if any(k in name for k in ("gemm", "gemv", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "elementwise, copy, concat, other"


def _trace(call, sleep_cycles: int) -> tuple[list, dict]:
    """The device kernels of the second of two traced calls of ``call``
    (the first is the trace's warm-up cycle: it can miss the kernels that
    start before the device tracing is running), each call queued between
    two sleeps of ``sleep_cycles`` (none if 0), and what the trace saw of
    the lead sleep: whether its kernel was recorded, and the ms from the
    traced step's start on the host to the first kernel of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            call()
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            torch.cuda.synchronize()
            prof.step()
    events = prof.events()
    # the schedule's "ProfilerStep*" span is recorded on the device timeline
    # too, as one event that covers the whole call: not a kernel; nor are
    # the sleeps ("spin_kernel")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep") and "spin_kernel" not in e.name]
    steps = [e.time_range.start for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("ProfilerStep")]
    seen = {"lead_sleep_seen": sleep_cycles > 0 and any("spin_kernel" in e.name and e.device_type == DeviceType.CUDA
                                                          for e in events),
            "first_kernel_after_step_start_ms": (min(e.time_range.start for e in kernels) - min(steps)) / 1e3
            if kernels and steps else None}
    return kernels, seen


def phase_profile(what: str, call, smi: str, inference: bool = True, expect: dict | None = None) -> dict:
    """Device time and kernels by category over one call of ``call`` (a
    denoiser call of a main path, B=8, under ``inference_mode``; or a train
    step): the device kernels of one traced call and the device's idle
    share against the call's time with Python's collector on, as a real
    call runs; returns the kernels by category.

    ``expect`` (category -> kernels) is checked exactly: a trace that holds
    more kernels of a category than expected fails at once.  One that holds
    fewer is traced again, up to ``TRACE_ATTEMPTS`` traces, each reported:
    the profiler drops the records of the kernels that run in the first
    milliseconds after the traced step starts (a whole run's trace of a
    train step held 47 of its 50 GroupNorm kernels behind a 1 ms lead
    sleep), so each traced call is queued behind a ~20 ms sleep, and a trace
    that still misses some shows whether the sleep itself was recorded.
    Also reported, not checked: the call's time with the collector off
    (timed in turns with it on, on / off / on / off) and the kernels a trace
    sees when the call is not queued behind a sleep."""
    import torch

    expect = expect or {}
    attempts = []
    with torch.inference_mode(inference):
        on, off = [], []
        for _ in range(2):
            on.append(time_ms(call, iters=5, warmup=1, gc_off=False))
            off.append(time_ms(call, iters=5, warmup=1, gc_off=True))
        step_ms, step_ms_gc_off = sum(on) / 2, sum(off) / 2
        for _ in range(TRACE_ATTEMPTS):
            events, seen = _trace(call, TRACE_SLEEP_CYCLES)
            counts = {}
            for e in events:
                counts[_category(e.name)] = counts.get(_category(e.name), 0) + 1
            attempts.append({"device_kernels": len(events), **seen,
                             **{c: counts.get(c, 0) for c in expect}})
            for c, n in expect.items():
                check(counts.get(c, 0) <= n, f"{what}: {counts.get(c, 0)} {c}s traced, more than {n}")
            if all(counts.get(c, 0) == n for c, n in expect.items()):
                break
        unslept, unslept_seen = _trace(call, 0)
    check(len(events) > 0, "the profiler saw no device kernels")
    for c, n in expect.items():
        check(counts.get(c, 0) == n, f"{what}: {counts.get(c, 0)} {c}s traced in each of {TRACE_ATTEMPTS} traces "
                                     f"{[a[c] for a in attempts]}, expected {n}")
    by_cat: dict[str, list] = {}
    by_name: dict[str, float] = {}
    for e in events:
        us = e.time_range.elapsed_us()
        cat = by_cat.setdefault(_category(e.name), [0.0, 0])
        cat[0] += us / 1e3
        cat[1] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    unslept_cats: dict[str, int] = {}
    for e in unslept:
        unslept_cats[_category(e.name)] = unslept_cats.get(_category(e.name), 0) + 1
    busy = sum(v[0] for v in by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "what": what, "card": smi, "step_ms": step_ms, "step_ms_runs": on,
          "step_ms_gc_off": step_ms_gc_off, "step_ms_gc_off_runs": off, "device_busy_ms": busy,
          "idle_share": max(0.0, 1.0 - busy / step_ms), "idle_share_gc_off": max(0.0, 1.0 - busy / step_ms_gc_off),
          "device_kernels": len(events), "trace_attempts": attempts,
          "by_category": {k: {"ms": v[0], "kernels": v[1]} for k, v in
                          sorted(by_cat.items(), key=lambda kv: -kv[1][0])},
          "top_kernels": [{"name": n[:90], "ms": ms} for n, ms in top],
          "trace_without_lead_sleep": {"device_kernels": len(unslept), "by_category": unslept_cats,
                                       **unslept_seen}})
    return {k: v[1] for k, v in by_cat.items()}


def profile_calls(cond_gen, uncond_gen):
    """One denoiser call (x̂_0 at t = 0.5, B=8, float32 in and out; the
    call itself in the generators' serving dtype) of each path."""
    import torch

    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch

    H, W = cond_gen.cfg.data.resolution
    x = torch.randn(BATCH, H, W, 2, device=DEVICE)
    t = torch.full((BATCH,), 0.5, device=DEVICE)
    with torch.inference_mode():
        cond = cond_gen.engine.get_network_condition(
            layout_condition_batch(cond_gen.cfg, BATCH, device=DEVICE))
    return {
        "layout": lambda: cond_gen.engine.predict_x_0(x, t, cond),
        "uncond": lambda: uncond_gen.engine.predict_x_0(x, t),
    }


# ------------------------------------------------------------------ phase 6


def event_spans(fn, spans: list):
    """``fn`` with a pair of CUDA events recorded around each call into
    ``spans``."""
    import torch

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    return timed


def geometry_on_card_and_cpu(gen, frame0) -> dict:
    """The first autoregressive frame's geometry step from the card's frame
    0, run on the card and on the CPU with the same boxes and transform;
    counts the condition pixels that differ by more than GEOMETRY_RTOL of
    max(1, max |CPU|).  Also times the step on the card: its device time
    (one step, a few hundred launches, queued while the card sleeps ~50 ms; more
    steps would fill the card's launch queue and block the host) and the
    host's time to queue one step (mean of 3)."""
    import torch

    from lidarcrafter_tpu_torch.pipeline.temporal import frame_conditions, image_points_carry, scene_tracks
    from lidarcrafter_tpu_torch.sample_temporal import synthetic_scenes
    from lidarcrafter_tpu_torch.training.factory import make_lidar_utils

    out = {}
    for dev, lu in ((DEVICE, gen.lidar_utils), ("cpu", make_lidar_utils(gen.autoreg.cfg, "cpu"))):
        tracks = scene_tracks(*synthetic_scenes(ROLLOUT_SCENES, seed=1), ROLLOUT_FRAMES, 16, torch.device(dev))
        with torch.inference_mode():
            carry = image_points_carry(torch.as_tensor(frame0, device=dev), lu)
            def step():
                return frame_conditions(*carry, tracks.boxes[:, 0], tracks.next_boxes[:, 0],
                                        tracks.transforms[:, 0], tracks.classes_col, tracks.box_mask, lu)

            out[dev] = step()
            if dev == DEVICE:
                device_ms = time_ms(step, iters=1, sleep_cycles=int(1e8), gc_off=False)
                t0 = time.perf_counter()
                for _ in range(3):
                    step()
                enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
                torch.cuda.synchronize()
    result = {"step_device_ms": device_ms, "step_enqueue_ms": enqueue_ms}
    for name, got, want in zip(("concat_cond", "autoregressive_cond"), out[DEVICE], out["cpu"]):
        tol = GEOMETRY_RTOL * max(1.0, float(want.abs().max()))
        diff = (got.cpu() - want).abs()
        flipped = int((diff > tol).any(-1).sum())
        pixels = want[..., 0].numel()
        check(flipped <= (1 - GEOMETRY_PIXEL_SHARE) * pixels,
              f"rollout geometry card vs CPU, {name}: {flipped} of {pixels} pixels differ")
        result[name] = {"pixels_differing": flipped, "pixels": pixels, "max_abs_err": float(diff.max()),
                        "tol": tol}
    return result


def phase_rollout(dtype, smi: str) -> tuple[dict, list]:
    """The 4D rollout on the card (phase 6); returns its launch counts and
    its frames (host arrays)."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import RolloutGenerator

    dname = str(dtype).split(".")[-1]
    t0 = time.perf_counter()
    gen = RolloutGenerator(get_config("nuscenes-box-layout-v6"), get_config("nuscenes-auto-reg-v2"),
                           DEVICE, 0, dtype, num_steps=2, mode="dpmpp_2m")
    pipe = gen.pipeline
    gen.generate(ROLLOUT_SCENES, num_frames=1, seed=99)  # warm-up: 1 + 1 frames, 2 steps
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pipe.num_sampling_steps = ROLLOUT_STEPS

    geometry, denoise = [], []
    pipe.frame_conditions = event_spans(pipe.frame_conditions, geometry)
    for engine in (pipe.cond_engine, pipe.autoreg_engine):
        engine.denoise = event_spans(engine.denoise, denoise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    frames = gen.generate(ROLLOUT_SCENES, num_frames=ROLLOUT_FRAMES, seed=1, stream_chunks=2)
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_frames, calls = ROLLOUT_FRAMES + 1, (ROLLOUT_FRAMES + 1) * ROLLOUT_STEPS
    check(len(frames) == n_frames, f"rollout {dname}: {len(frames)} frames, expected {n_frames}")
    for i, f in enumerate(frames):
        check(f.shape == (ROLLOUT_SCENES, *pipe.lidar_utils.resolution, 2), f"rollout {dname} frame {i}: shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"rollout {dname} frame {i} is not finite")
        check(float(f.std()) > 1e-3, f"rollout {dname} frame {i} is constant")
    per_call = {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}
    for k, n in launches.items():
        want = per_call.get(k, 0) * calls
        check(n == want, f"rollout {dname}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    check(len(geometry) == ROLLOUT_FRAMES and len(denoise) == calls,
          f"rollout {dname}: {len(geometry)} geometry steps, {len(denoise)} denoiser calls")
    geometry_ms = [a.elapsed_time(b) for a, b in geometry]
    denoise_ms = [a.elapsed_time(b) for a, b in denoise]
    card_vs_cpu = geometry_on_card_and_cpu(gen, frames[0])
    emit({"phase": "rollout", "dtype": dname, "card": smi, "scenes": ROLLOUT_SCENES, "frames": n_frames,
          "mode": "dpmpp_2m", "steps": ROLLOUT_STEPS, "denoiser_calls": calls, "seconds": seconds,
          "frames_per_s": n_frames * ROLLOUT_SCENES / seconds,
          "geometry_ms_per_frame": sum(geometry_ms) / len(geometry_ms), "geometry_ms_max": max(geometry_ms),
          "geometry_share": sum(geometry_ms) / 1e3 / seconds,
          "denoiser_ms_per_call": sum(denoise_ms) / len(denoise_ms),
          "outside_denoiser_share": 1.0 - sum(denoise_ms) / 1e3 / seconds,
          "peak_memory_gb": peak_gb, "launches": launches, "setup_and_warmup_seconds": setup_s,
          "frame_std": [float(f.std()) for f in frames], "card_vs_cpu_geometry": card_vs_cpu})
    return {k: n for k, n in launches.items() if n}, frames


# ------------------------------------------------------------------ phase 7


BACKWARD_LIBRARY = {
    "oaca": "F.scaled_dot_product_attention forward + backward on the concatenated strips",
    "attention": "F.scaled_dot_product_attention forward + backward",
    "groupnorm": "F.group_norm forward + backward (affine only)",
}


def _backward_case(kernel, dtype, gen):
    """The operands of one route at its largest main-path shape (B=8), as
    leaves that require grad, laid out as the blocks pass them; returns
    (label, leaves, ops(), kernel call, plain call, backward call(g),
    library forward + backward call(g), bytes, flops)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

    def leaf(t):
        return t.to(dtype).requires_grad_()

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    elt = torch.finfo(dtype).bits // 8
    if kernel == "oaca":
        B, H, L, L2 = BATCH, 8, 2048, 13
        C = H * 32
        qkv, ipe, k_l, v_l = leaf(r(B, L, 3 * C)), leaf(r(B, L, C)), leaf(r(B, H, L2, 64)), leaf(r(B, L2, C))
        heads = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)  # noqa: E731
        scale = 1.0 / math.sqrt(math.sqrt(64))

        def ops():
            q_c, k_c, v_c = (heads(t) for t in qkv.chunk(3, dim=-1))
            return q_c, heads(ipe), k_c, k_l, v_c, heads(v_l)

        saved = [t.detach() for t in ops()]
        q_img = torch.cat([saved[0], saved[1]], -1).detach().requires_grad_()
        k_mix = torch.cat([torch.cat([saved[2], saved[1]], -1), saved[3]], 2).detach().requires_grad_()
        v_mix = torch.cat([saved[4], saved[5]], 2).detach().requires_grad_()

        def library(g):
            out = F.scaled_dot_product_attention(q_img, k_mix, v_mix, scale=scale**2)
            return torch.autograd.grad(out, (q_img, k_mix, v_mix), g)

        n_ops = 4 * B * H * L * 32 + B * H * L2 * 96  # q_c, ipe, k_c, v_c; k_l, v_l
        return ("ds4 B=8 h=8 L=2048+13", [qkv, ipe, k_l, v_l],
                lambda: oaca.oaca_attention(*ops(), scale=scale),
                lambda: oaca.oaca_attention_plain(*ops(), scale=scale),
                lambda g: oaca.oaca_attention_backward(saved, g, scale=scale), library,
                elt * (2 * n_ops + 2 * B * H * L * 32), 2.0 * B * H * L * (L + L2) * (3 * 64 + 2 * 32))
    if kernel == "attention":
        B, H, L, d = BATCH, 8, 512, 64
        qkv = leaf(r(B, L, 3 * H * d))

        def ops():
            return [t.reshape(B, L, H, d).transpose(1, 2) for t in qkv.split(H * d, dim=-1)]

        saved = [t.detach() for t in ops()]
        lib_ops = [t.clone().requires_grad_() for t in saved]

        def library(g):
            out = F.scaled_dot_product_attention(*lib_ops, scale=d**-0.5)
            return torch.autograd.grad(out, lib_ops, g)

        return ("d_block4 B=8 h=8 L=512 d=64", [qkv],
                lambda: attention.attention(*ops(), scale=d**-0.5),
                lambda: attention.attention_plain(*ops(), scale=d**-0.5),
                lambda g: attention.attention_backward(*saved, g, scale=d**-0.5), library,
                elt * B * H * L * d * 8, 2.0 * B * H * L * L * 5 * d)
    label, shape, ss = {
        "groupnorm 192": ("level0 (8,32,1024,192) in_norm out_0_0_res + SiLU", (BATCH, 32, 1024, 192), False),
        "groupnorm 64": ("level0 (8,32,1024,64) out_norm scale-shift + SiLU", (BATCH, 32, 1024, 64), True),
    }[kernel]
    C = shape[-1]
    x, w, b = leaf(r(*shape) * 2 + 1), leaf(1 + 0.1 * r(C)), leaf(0.1 * r(C))
    proj = leaf(0.3 * r(BATCH, 2 * C)) if ss else None

    def args():
        s, t = proj.chunk(2, dim=-1) if ss else (None, None)
        return dict(num_groups=32, eps=1e-5, scale=s, shift=t, silu=True)

    a = args()
    saved = [t if t is None else t.detach() for t in (x, w, b, a["scale"], a["shift"])]
    lib_ops = [t.detach().clone().requires_grad_() for t in (x, w, b)]

    def library(g):
        x_nchw = lib_ops[0].reshape(BATCH, -1, 1, C).permute(0, 3, 1, 2)
        out = F.group_norm(x_nchw, 32, lib_ops[1], lib_ops[2], 1e-5)
        return torch.autograd.grad(out, lib_ops, g.reshape(BATCH, -1, 1, C).permute(0, 3, 1, 2))

    n = x.numel()
    return (label, [t for t in (x, w, b, proj) if t is not None],
            lambda: groupnorm.group_norm(x, w, b, **args()), lambda: groupnorm.group_norm_plain(x, w, b, **args()),
            lambda g: groupnorm.group_norm_backward(saved, g, num_groups=32, eps=1e-5, silu=True), library,
            elt * 4 * n, 30.0 * n)


def check_backward(kernel: str, dtype, gen) -> dict:
    """Phase 7 (a): one route's gradients through the kernel (forward
    kernel, backward recompute) against autograd through the plain version,
    both limits per operand; device times of the backward, of autograd's
    backward through the plain version, and of the library's forward +
    backward."""
    import torch

    label, leaves, through_kernel, plain, backward, library, nbytes, flops = _backward_case(kernel, dtype, gen)
    out = through_kernel()
    check(out.grad_fn is not None, f"{kernel} backward: the kernel route has no grad_fn")
    g = torch.randn(out.shape, generator=gen, device=DEVICE).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    want_out = plain()
    want = torch.autograd.grad(want_out, leaves, g, retain_graph=True)
    dname = str(dtype).split(".")[-1]
    errs = [kernel_errors(f"{kernel} backward operand {i}", dname, a, b) for i, (a, b) in enumerate(zip(got, want))]
    worst = {k: max(e[k] for e in errs) for k in ("max_abs_err", "rel_err", "norm_rel_err")}
    del got, want, out
    bound, by = bound_ms(nbytes, flops, work_route(kernel, dname))
    row = {
        "kernel": kernel, "pass": "backward", "shape": label, "dtype": dname, "route": PLAIN_ROUTE,
        **worst, "tol": TOL[dname], "norm_tol": NORM_TOL[dname],
        "ms": time_ms(lambda: backward(g), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.autograd.grad(want_out, leaves, g, retain_graph=True), iters=5, warmup=1),
        "library_ms": time_ms(lambda: library(g), iters=5, warmup=1), "library": BACKWARD_LIBRARY[kernel.split()[0]],
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }
    check(row["ms"] >= bound, f"{kernel} backward {dname}: {row['ms']} ms below its bound {bound} ms")
    del want_out
    torch.cuda.empty_cache()
    return row


def phase_backward() -> list:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("oaca", "attention", "groupnorm 192", "groupnorm 64"):
            rows.append(check_backward(kernel, dtype, gen))
            emit({"phase": "train", "check": "backward", **rows[-1]})
    return rows


def _train_cfg(cfg_name: str, batch: int, amp: bool, **training):
    """``cfg_name`` with its training fields overridden."""
    from lidarcrafter_tpu_torch.configs import get_config

    cfg = get_config(cfg_name)
    cfg.training.batch_size_train = batch
    cfg.training.mixed_precision = "bf16" if amp else "no"
    for k, v in training.items():
        setattr(cfg.training, k, v)
    return cfg


def _trainer(cfg_name: str, batch: int, amp: bool, out_dir: str, **training):
    """The train CLI's trainer for ``cfg_name`` (``Trainer``, ``FlowTrainer``,
    ``LayoutTrainer`` or ``ObjectTrainer``) over its synthetic source, with
    the training config's fields overridden; returns it and its log."""
    from lidarcrafter_tpu_torch import train as train_cli

    logs = []
    trainer = train_cli.build_trainer(_train_cfg(cfg_name, batch, amp, **training), 5, DEVICE, output_dir=out_dir,
                                      log_fn=logs.append)
    return trainer, logs


def phase_train_speed(cfg_name: str, amp: bool, per_step: dict, smi: str, out_dir: str) -> dict:
    """Phase 7 (c): ``TRAIN_WARMUP`` then ``TRAIN_TIMED`` steps at B=8 with
    the launch counters set to 0 just before the timed steps and read just
    after (exact counts per step); returns the non-zero counts."""
    import torch

    trainer, logs = _trainer(cfg_name, BATCH, amp, out_dir)
    total = TRAIN_WARMUP + TRAIN_TIMED
    state = trainer.train(num_steps=TRAIN_WARMUP, seed=0, checkpoint_every=10**9, log_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    state = trainer.train(num_steps=total, state=state, checkpoint_every=10**9, log_every=total)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    dname = "bfloat16 AMP" if amp else "float32"
    for k, n in launches.items():
        want = per_step.get(k, 0) * TRAIN_TIMED
        check(n == want, f"train {cfg_name} {dname}: {k} launches {n} != {per_step.get(k, 0)} x {TRAIN_TIMED}")
    loss = logs[-1]["loss"]
    check(logs[-1]["step"] == total and math.isfinite(loss), f"train {cfg_name} {dname}: loss {loss}")
    emit({"phase": "train", "check": "speed", "config": cfg_name, "dtype": dname, "batch": BATCH,
          "card": smi, "timed_steps": TRAIN_TIMED, "seconds": seconds, "steps_per_s": TRAIN_TIMED / seconds,
          "frames_per_s": TRAIN_TIMED * BATCH / seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "loss": loss})
    # where a step's device time goes; its forward holds every GroupNorm kernel
    batch = trainer.prepare_batch(next(trainer.data_iter))
    phase_profile(f"one train step ({cfg_name}), B=8, {dname}", lambda: trainer.step_fn(state, batch, 0), smi,
                  inference=False, expect={f"{k} kernel": per_step.get(k, 0) for k in ("groupnorm", "attention", "oaca")})
    del trainer, state
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}


def _loss_gate(cfg_name: str, batch: int, per_step: dict, smi: str, out_dir: str):
    """``cfg_name``'s trainer for ``GATE_STEPS`` steps at ``batch``, float32,
    lr 1e-4 with 20 warm-up steps, the launch counters set to 0 just before
    and read just after (``per_step`` launches a step, 0 if absent): the
    mean of the last 10 losses must lie below that of the first 10.
    Returns the final state, its checkpoint and the launch counts."""
    from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint

    out_dir = str(Path(out_dir) / cfg_name)
    trainer, logs = _trainer(cfg_name, batch, False, out_dir, lr=1e-4, lr_warmup_steps=20, num_steps=GATE_STEPS)
    counters = reset_counters()
    t0 = time.perf_counter()
    state = trainer.train(num_steps=GATE_STEPS, seed=0, checkpoint_every=GATE_STEPS, log_every=1)
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    for k, n in launches.items():
        check(n == per_step.get(k, 0) * GATE_STEPS, f"{cfg_name} loss gate: {k} launches {n}")
    losses = [r["loss"] for r in logs if "loss" in r]
    check(len(losses) == GATE_STEPS and all(math.isfinite(v) for v in losses), f"{cfg_name} loss gate: losses")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    emit({"phase": "train", "check": "loss falls", "config": cfg_name, "batch": batch, "dtype": "float32",
          "steps": GATE_STEPS, "lr": 1e-4, "warmup": 20, "card": smi, "seconds": seconds,
          "first10_mean": first, "last10_mean": last, "ratio": last / first, "launches": launches,
          "losses_every_10": losses[::10]})
    check(last < first, f"{cfg_name} loss gate: mean of the last 10 losses {last:.4g} >= the first 10 {first:.4g}")
    path = latest_checkpoint(out_dir)
    check(path is not None and path.endswith(f"ckpt_{GATE_STEPS:010d}"), f"{cfg_name} loss gate: checkpoint {path}")
    del trainer
    return state, path, {k: n for k, n in launches.items() if n}


def _check_ema_served(what: str, models: dict, state) -> None:
    """The served ``models`` hold the EMA tensors of ``state``, running
    statistics included, bit for bit."""
    import torch

    for key, module in models.items():
        mine = module.state_dict()
        for name, value in state.ema[key].state_dict().items():
            check(torch.equal(mine[name], value), f"{what} checkpoint round trip: {key}.{name} differs")


def phase_train_gate(smi: str, out_dir: str) -> dict:
    """Phase 7 (d) and (e): ``nuscenes-auto-reg-v2`` trained ``GATE_STEPS``
    steps, its checkpoint served through ``sample_temporal``'s loader;
    returns the launch counts of the training run."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import RolloutGenerator

    state, path, launches = _loss_gate("nuscenes-auto-reg-v2", GATE_BATCH,
                                       {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}, smi, out_dir)
    gen = RolloutGenerator(get_config("nuscenes-box-layout-v6"), get_config("nuscenes-auto-reg-v2"), DEVICE, 0,
                           torch.float32, num_steps=15, mode="dpmpp_2m", autoreg_ckpt=path)
    _check_ema_served("nuscenes-auto-reg-v2", gen.autoreg.models, state)
    sample, post = gen.autoreg.generate(1, 15, mode="dpmpp_2m", seed=0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sample).all()) and bool(torch.isfinite(post["xyz"]).all()),
          "a frame sampled from the trained checkpoint is not finite")
    emit({"phase": "train", "check": "checkpoint serves", "checkpoint": Path(path).name,
          "ema_weights_equal": True, "sample_shape": list(sample.shape), "sample_std": float(sample.std()),
          "valid_depth_share": float((post["depth"] > 0).float().mean())})
    del state, gen
    torch.cuda.empty_cache()
    return launches


def phase_train(smi: str) -> tuple[list, dict]:
    """Phase 7; returns the backward rows and the train paths' launches."""
    rows = phase_backward()
    phase_step_parity("nuscenes-box-layout-v6", smi, "train")
    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for amp in (False, True):
            dname = "bfloat16 AMP" if amp else "float32"
            by_path[f"train nuscenes-box-layout-v6 {dname}"] = phase_train_speed(
                "nuscenes-box-layout-v6", amp, {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}, smi, out_dir)
            by_path[f"train nuscenes-unet-uncond {dname}"] = phase_train_speed(
                "nuscenes-unet-uncond", amp, {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET}, smi, out_dir)
        by_path["train nuscenes-auto-reg-v2 float32 (loss gate)"] = phase_train_gate(smi, out_dir)
    return rows, by_path


# ------------------------------------------------------------------ phase 8


def _branch_call(gen, request_fn, x, t):
    """One denoiser call of a branch's generator (its encoder, then the
    denoiser at log-SNR ``t``) on ``x``, on the generator's device; returns
    (condition, prediction)."""
    import torch

    with torch.inference_mode():
        cond = gen.engine.get_network_condition(request_fn(gen.device))
        return cond, gen.engine.denoise(x.to(gen.device), t.to(gen.device), cond)


def _on_cpu(gen):
    """A copy of ``gen`` whose models and engine live on the CPU."""
    import torch

    cpu = copy.copy(gen)
    cpu.models = {k: copy.deepcopy(m).cpu() for k, m in gen.models.items()}
    cpu.engine = dataclasses.replace(gen.engine, model=cpu.models["model"], cond_model=cpu.models["cond"])
    cpu.device = torch.device("cpu")
    return cpu


def _branch_requests(name: str, generate, check_out, per_call: dict, smi: str) -> tuple[list, dict]:
    """``BRANCH_REQUESTS`` through ``generate(steps, mode, seed)`` after one
    warm-up, the launch counters set to 0 just before and read just after;
    each kernel must have launched ``per_call[kernel]`` times a denoiser
    call (0 if absent).  Returns the requests' lines and the counts."""
    import torch

    generate(2, "ddim", 99)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    results = []
    for i, (mode, steps) in enumerate(BRANCH_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(steps, mode, i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        results.append({"mode": mode, "steps": steps, "denoiser_calls": steps, "seconds": seconds,
                        "ms_per_call": seconds * 1e3 / steps, **check_out(out, mode)})
    launches = {k: c.n for k, c in counters.items()}
    calls = sum(s for _, s in BRANCH_REQUESTS)
    for k, n in launches.items():
        check(n == per_call.get(k, 0) * calls, f"{name}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    return results, launches


def phase_layout(smi: str) -> dict:
    """Phase 8a: scene graph → 4D layout (``nuscenes-layout`` at its
    published widths, float32) through ``LayoutGenerator``; returns the
    launch counts of its requests."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.datasets.transforms import unscale_boxes_3d
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator, layout_request
    from lidarcrafter_tpu_torch.models.ops import GroupNorm32
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_scene_graphs

    t0 = time.perf_counter()
    gen = LayoutGenerator(get_config("nuscenes-layout"), DEVICE, 0)
    build_s = time.perf_counter() - t0
    n = sum(isinstance(m, GroupNorm32) for m in gen.models["model"].modules())
    check(n == GN_PER_UNET1D, f"nuscenes-layout: {n} GroupNorm32 modules, expected {GN_PER_UNET1D}")
    batch = synthetic_scene_graphs(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0)
    N, T = len(batch["decoder"]["objs"]), len(batch["decoder"]["tripltes"])
    x = torch.randn(N, 20, generator=torch.Generator().manual_seed(30))
    t = torch.linspace(-5.0, 5.0, N)  # log-SNR, a spread of noise levels across the nodes

    counters = reset_counters()
    cond, got = _branch_call(gen, lambda d: layout_request(batch, d), x, t)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    check(launches == {"oaca": 0, "groupnorm": GN_PER_UNET1D, "attention": 0},
          f"nuscenes-layout: one denoiser call launched {launches}")
    cpu = _on_cpu(gen)
    t0 = time.perf_counter()
    want_cond, want = _branch_call(cpu, lambda d: layout_request(batch, d), x, t)
    cpu_s = time.perf_counter() - t0
    del cpu
    check_forward("nuscenes-layout SceneGraph latent (c_b) float32", cond["other_condition"]["c_b"].cpu(),
                  want_cond["other_condition"]["c_b"], FORWARD_RTOL, nodes=N, triples=T)
    check_forward("nuscenes-layout denoiser call (SceneGraph + UNet1DModel) float32", got.cpu(), want,
                  FORWARD_RTOL, nodes=N, triples=T, cpu_seconds=cpu_s, launches=launches)

    t_full = torch.full((N,), 0.5, device=DEVICE)
    x_card = x.to(DEVICE)
    phase_profile(f"one denoiser call (nuscenes-layout, predict_x_0), N={N}, float32",
                  lambda: gen.engine.predict_x_0(x_card, t_full, cond), smi, expect={"groupnorm kernel": GN_PER_UNET1D})

    def check_out(raw, mode):
        raw = raw.cpu().numpy()
        check(raw.shape == (N, 20), f"layout {mode}: shape {raw.shape}")
        check(bool(np.isfinite(raw).all()), f"layout {mode}: sample is not finite")
        check(float(raw.std()) > 1e-3, f"layout {mode}: sample is constant")
        with np.errstate(over="ignore"):
            boxes, trajs = unscale_boxes_3d(raw)
        # centre, yaw and trajectories are finite functions of the sample;
        # the sizes are exp(log size), which an untrained denoiser's
        # unclipped x̂_0 may overflow: counted, not held
        check(bool(np.isfinite(boxes[:, [0, 1, 2, 6]]).all()) and bool(np.isfinite(trajs).all()),
              f"layout {mode}: unscale_boxes_3d centres, yaw or trajectories not finite")
        return {"sample_abs_mean": float(np.abs(raw).mean()), "sample_abs_max": float(np.abs(raw).max()),
                "finite_sizes_share": float(np.isfinite(boxes[:, 3:6]).mean())}

    results, launches = _branch_requests(
        "nuscenes-layout", lambda steps, mode, seed: gen.generate(batch, steps, mode=mode, seed=seed),
        check_out, {"groupnorm": GN_PER_UNET1D}, smi)
    emit({"phase": "layout", "config": "nuscenes-layout", "dtype": "float32", "card": smi, "scenes": LAYOUT_SCENES,
          "nodes": N, "triples": T, "requests": results, "launches": launches,
          "groupnorm_per_call": GN_PER_UNET1D, "build_seconds": build_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del gen
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}


def phase_object(smi: str) -> None:
    """Phase 8b: box + class → object points (``nuscenes-object``, float32)
    through ``ObjectGenerator``, for the 96 objects of the layout phase's
    scenes.  No kernel of the port runs on this path (Linears and pointwise
    ops); the launch counters must stay at 0."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes

    gen = ObjectGenerator(get_config("nuscenes-object"), DEVICE, 0)
    boxes = synthetic_object_boxes(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0)
    B, P = len(boxes["fg_class"]), gen.cfg.data.num_samples

    def request(device):
        return {k: torch.as_tensor(v, device=device) for k, v in boxes.items()}

    x = torch.randn(B, P, 4, generator=torch.Generator().manual_seed(31))
    t = torch.linspace(-5.0, 5.0, B)
    counters = reset_counters()
    _, got = _branch_call(gen, request, x, t)
    torch.cuda.synchronize()
    check(all(c.n == 0 for c in counters.values()), "nuscenes-object: a kernel launched in a denoiser call")
    cpu = _on_cpu(gen)
    t0 = time.perf_counter()
    _, want = _branch_call(cpu, request, x, t)
    cpu_s = time.perf_counter() - t0
    del cpu
    check_forward("nuscenes-object denoiser call (ObjectGenEncoder + PointUNet) float32", got.cpu(), want,
                  FORWARD_RTOL, objects=B, points=P, cpu_seconds=cpu_s)
    with torch.inference_mode():
        cond = gen.engine.get_network_condition(request(DEVICE))
    x_card, t_half = x.to(DEVICE), torch.full((B,), 0.5, device=DEVICE)
    phase_profile(f"one denoiser call (nuscenes-object, predict_x_0), B={B}, {P} points, float32",
                  lambda: gen.engine.predict_x_0(x_card, t_half, cond), smi,
                  expect={"groupnorm kernel": 0, "attention kernel": 0, "oaca kernel": 0})

    def check_out(out, mode):
        check(tuple(out.shape) == (B, P, 4), f"object {mode}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"object {mode}: sample is not finite")
        check(float(out.std()) > 1e-3, f"object {mode}: sample is constant")
        return {"sample_abs_mean": float(out.abs().mean()), "sample_abs_max": float(out.abs().max())}

    results, launches = _branch_requests(
        "nuscenes-object", lambda steps, mode, seed: gen.generate(boxes, steps, mode=mode, seed=seed),
        check_out, {}, smi)
    emit({"phase": "object", "config": "nuscenes-object", "dtype": "float32", "card": smi, "objects": B,
          "points": P, "requests": results, "launches": launches, "kernels": "none on this path",
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del gen
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 9


# the tangent of a forward-mode route: the plain version's, in float32 from a recompute
JVP_ROUTE = "kernel forward + plain f32 tangent"
BRANCH_PER_STEP = {  # kernel launches a train step of each branch
    "nuscenes-layout": {"groupnorm": GN_PER_UNET1D},
    "nuscenes-object": {},
    "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
}
# card-vs-CPU step batches: 8 scenes of ego + 12 (budgets 112 / 3,536), the
# 96 objects of those scenes, 2 frames (MeanFlow), 1 frame (v6)
PARITY_BATCH = {"nuscenes-layout": LAYOUT_SCENES, "nuscenes-object": LAYOUT_SCENES * LAYOUT_OBJECTS,
                "meanflow-nusc": 2, "nuscenes-box-layout-v6": 1}
# the loss gates: 8 scenes; 96 objects (at 8, a step's loss spreads as far as
# 100 steps move its mean); 2 frames
GATE_BATCH_BRANCH = {"nuscenes-layout": LAYOUT_SCENES, "nuscenes-object": LAYOUT_SCENES * LAYOUT_OBJECTS,
                     "meanflow-nusc": 2}


def _jvp_case(kernel: str, label: str, dtype, gen):
    """(wrapper call, plain call, primals, tangents, bytes, forward flops,
    tangent flops) of one route at a MeanFlow UNet shape,
    the operands laid out as the blocks pass them: attention on per-head
    views of one (B, L, 3C) projection, GroupNorm on x with the AdaGN
    scale-shift halves of one (B, 2C) projection or the norm's own affine."""
    import torch

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=DEVICE)).to(dtype)

    elt = torch.finfo(dtype).bits // 8
    if kernel == "attention":
        B, H, L, d = BATCH, 8, 512, int(label.rsplit("d=", 1)[1])
        C = H * d

        def heads(qkv):
            return [t.reshape(B, L, H, d).transpose(1, 2) for t in qkv.split(C, dim=-1)]

        primals, tangents = (r(B, L, 3 * C),), (r(B, L, 3 * C),)
        return (lambda qkv: attention.attention(*heads(qkv), scale=d**-0.5),
                lambda qkv: attention.attention_plain(*heads(qkv), scale=d**-0.5), primals, tangents,
                elt * 8 * B * L * C, 4.0 * B * H * L * L * d, 8.0 * B * H * L * L * d)
    if "AdaGN" in label:
        shape, C = (BATCH, 32, 1024, 64), 64

        def args(proj):
            s, t = proj.chunk(2, dim=-1)
            return dict(num_groups=8, eps=1e-6, scale=s, shift=t, silu=True)

        primals = (r(*shape, scale=2.0) + 1, r(BATCH, 2 * C, scale=0.3))
        tangents = (r(*shape), r(BATCH, 2 * C))
        call = lambda x, proj: groupnorm.group_norm(x, None, None, **args(proj))  # noqa: E731
        plain = lambda x, proj: groupnorm.group_norm_plain(x, None, None, **args(proj))  # noqa: E731
        small = 4 * BATCH * C
    else:
        shape, C = (BATCH, 4, 128, 512), 512
        args = dict(num_groups=8, eps=1e-6, silu=True)
        primals = (r(*shape, scale=2.0) + 1, 1 + r(C, scale=0.1), r(C, scale=0.1))
        tangents = (r(*shape), r(C, scale=0.1), r(C, scale=0.1))
        call = lambda x, w, b: groupnorm.group_norm(x, w, b, **args)  # noqa: E731
        plain = lambda x, w, b: groupnorm.group_norm_plain(x, w, b, **args)  # noqa: E731
        small = 4 * C
    n = math.prod(shape)
    # x and its tangent read, y and its tangent written, the affine operands and theirs read
    return call, plain, primals, tangents, elt * (4 * n + small), 10.0 * n, 20.0 * n


def check_jvp(kernel: str, label: str, dtype, gen) -> dict:
    """Phase 9 (a): one route under ``torch.func.jvp`` through the wrapper
    (one kernel launch, the tangent from the route's forward-mode rule) and
    under ``forward_ad``, against ``torch.func.jvp`` through the plain
    version, primal and tangent to the forward rows' limits; device times
    of the jvp through the route and through the plain version."""
    import torch
    from torch.autograd import forward_ad

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm

    call, plain, primals, tangents, nbytes, fwd_flops, tan_flops = _jvp_case(kernel, label, dtype, gen)
    counter = {"attention": attention.launches, "groupnorm": groupnorm.launches}[kernel]
    dname = str(dtype).split(".")[-1]
    n = counter.n
    out, tan = torch.func.jvp(call, primals, tangents)
    with forward_ad.dual_level():
        dual_out, dual_tan = forward_ad.unpack_dual(call(*(forward_ad.make_dual(a, t)
                                                           for a, t in zip(primals, tangents))))
    torch.cuda.synchronize()
    check(counter.n == n + 2, f"{kernel} jvp {label} {dname}: {counter.n - n} launches for 2 calls")
    want_out, want_tan = torch.func.jvp(plain, primals, tangents)
    kernel_errors(f"{kernel} jvp {label} primal", dname, out, want_out)
    kernel_errors(f"{kernel} jvp {label} forward_ad tangent", dname, dual_tan, want_tan)
    errors = kernel_errors(f"{kernel} jvp {label} tangent", dname, tan, want_tan)
    del out, tan, dual_out, dual_tan, want_out, want_tan
    bound, by = bound_ms(nbytes, fwd_flops + tan_flops, work_route(kernel, dname))
    row = {
        "kernel": kernel, "pass": "jvp", "shape": label, "dtype": dname, "route": JVP_ROUTE, **errors,
        "ms": time_ms(lambda: torch.func.jvp(call, primals, tangents), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.func.jvp(plain, primals, tangents), iters=5, warmup=1),
        "library_ms": None, "library": "none: no one PyTorch call computes a tangent",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": fwd_flops + tan_flops,
    }
    check(row["ms"] >= bound, f"{kernel} jvp {label} {dname}: {row['ms']} ms below its bound {bound} ms")
    torch.cuda.empty_cache()
    return row


def phase_jvp() -> list:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, label in (("attention", "d_block4 B=8 h=8 L=512 d=64"), ("attention", "u_block4 B=8 h=8 L=512 d=32"),
                              ("groupnorm", "unet level0 (8,32,1024,64) AdaGN scale-shift+SiLU"),
                              ("groupnorm", "unet ds8 (8,4,128,512) SiLU")):
            rows.append(check_jvp(kernel, label, dtype, gen))
            emit({"phase": "branch_train", "check": "jvp", **rows[-1]})
    return rows


def _step_draws(cfg_name: str, trainer, batch) -> dict:
    """A step's draws, made on the CPU from a seed, so that the card and the
    CPU take the same step."""
    import torch

    gen = torch.Generator().manual_seed(23)
    if cfg_name == "nuscenes-layout":
        return {"t_scene": torch.rand(trainer.cfg.training.batch_size_train, generator=gen),
                "noise": torch.randn(trainer.max_nodes, 20, generator=gen)}
    x_0 = batch["x_0"] if isinstance(batch, dict) else batch
    draws = {}
    if cfg_name == "meanflow-nusc":
        draws["t"], draws["r"] = trainer.engine.sample_t_r(x_0.shape[0], gen)
    else:
        draws["t"] = torch.rand(x_0.shape[0], generator=gen)
    draws["noise"] = torch.randn(x_0.shape, generator=gen)
    return draws


def phase_step_parity(cfg_name: str, smi: str, phase: str) -> None:
    """Phase 7 (b), phase 9 (b): one full-width float32 step of
    ``cfg_name``'s trainer at ``PARITY_BATCH``, the card (kernels) against
    the CPU (plain versions) on the same weights, batch and draws: the loss
    to ``TRAIN_LOSS_RTOL``, every trained tensor's gradient to
    ``TRAIN_GRAD_RTOL`` relative L2."""
    import torch

    from lidarcrafter_tpu_torch import train as train_cli
    from lidarcrafter_tpu_torch.training.state import named_module_params
    from lidarcrafter_tpu_torch.training.train_step import loss_and_grads

    cfg = _train_cfg(cfg_name, PARITY_BATCH[cfg_name], False)
    cpu = train_cli.build_trainer(cfg, 5, "cpu", log_fn=None)
    cpu.init_state(21)
    card = train_cli.build_trainer(cfg, 5, DEVICE, log_fn=None)
    for k, m in card.models.items():
        m.load_state_dict(cpu.models[k].state_dict())
    raw = next(cpu.data_iter)
    want_batch, batch = cpu.prepare_batch(raw), card.prepare_batch(raw)
    draws = _step_draws(cfg_name, cpu, want_batch)
    names, want_params = zip(*named_module_params(cpu.models))
    kw = cpu._loss_kwargs()
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(cpu.engine, list(want_params), want_batch, cpu.loss_has_aux, **draws, **kw)
    cpu_s = time.perf_counter() - t0
    loss, got = loss_and_grads(card.engine, [t for _, t in named_module_params(card.models)], batch,
                               card.loss_has_aux, **{k: v.to(DEVICE) for k, v in draws.items()}, **kw)
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    total = math.sqrt(sum(float(w.norm()) ** 2 for w in want))
    rows = []
    for name, a, b in zip(names, got, want):
        diff, ref = float((a.cpu() - b).norm()), float(b.norm())
        rows.append((diff / max(ref, 1e-30), name, ref, diff))
    rows.sort(reverse=True)
    overall = math.sqrt(sum(r[3] ** 2 for r in rows)) / total
    emit({"phase": phase, "check": "step parity", "config": cfg_name, "batch": PARITY_BATCH[cfg_name],
          "dtype": "float32", "card": smi, "loss_card": float(loss), "loss_cpu": float(want_loss),
          "loss_rel_err": loss_rel, "loss_tol": TRAIN_LOSS_RTOL, "grad_tol": TRAIN_GRAD_RTOL,
          "grad_overall_rel_l2": overall, "tensors": len(rows), "zero_gradients": sum(r[2] == 0 for r in rows),
          "cpu_seconds": cpu_s, "worst_tensors": [{"name": n, "rel_l2": e, "norm": ref} for e, n, ref, _ in rows[:5]]})
    check(loss_rel <= TRAIN_LOSS_RTOL, f"{cfg_name} step parity: loss relative error {loss_rel:.3g}")
    for e, name, ref, diff in rows:
        check(e <= TRAIN_GRAD_RTOL, f"{cfg_name} step parity: {name} gradient relative L2 {e:.3g} (norm {ref:.3g})")
    del cpu, card, got
    torch.cuda.empty_cache()


def phase_branch_gate(cfg_name: str, smi: str, out_dir: str) -> dict:
    """Phase 9 (e) and (f): ``cfg_name``'s loss gate, then its checkpoint
    served through the branch's generator (EMA weights and running
    statistics bit for bit, finite output); returns the gate's launches."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator
    from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes, synthetic_scene_graphs

    state, path, launches = _loss_gate(cfg_name, GATE_BATCH_BRANCH[cfg_name], BRANCH_PER_STEP[cfg_name], smi,
                                       out_dir)
    cfg = get_config(cfg_name)
    if cfg_name == "nuscenes-layout":
        gen = LayoutGenerator(cfg, DEVICE, ckpt=path)
        out = gen.generate(synthetic_scene_graphs(2, LAYOUT_OBJECTS, seed=1), 10, mode="ddim")
    elif cfg_name == "nuscenes-object":
        gen = ObjectGenerator(cfg, DEVICE, ckpt=path)
        out = gen.generate(synthetic_object_boxes(1, BATCH, seed=1), 10, mode="ddim")
    else:
        gen = FlowFrameGenerator(cfg, DEVICE, ckpt=path, ema=True)
        gen.models = {"model": gen.model}  # the one module the flow generator holds
        out, _ = gen.generate(2)
    _check_ema_served(cfg_name, gen.models, state)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{cfg_name}: a sample from the trained checkpoint is not finite")
    emit({"phase": "branch_train", "check": "checkpoint serves", "config": cfg_name, "checkpoint": Path(path).name,
          "ema_weights_equal": True, "sample_shape": list(out.shape), "sample_std": float(out.std())})
    del state, gen
    torch.cuda.empty_cache()
    return launches


def phase_branch_train(smi: str) -> tuple[list, dict]:
    """Phase 9; returns the jvp rows and the branch training paths' launches."""
    rows = phase_jvp()
    for cfg_name in BRANCH_PER_STEP:
        phase_step_parity(cfg_name, smi, "branch_train")
    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for cfg_name, per_step in BRANCH_PER_STEP.items():
            for amp in (False, True):
                dname = "bfloat16 AMP" if amp else "float32"
                by_path[f"train {cfg_name} {dname}"] = phase_train_speed(cfg_name, amp, per_step, smi, out_dir)
            by_path[f"train {cfg_name} float32 (loss gate)"] = phase_branch_gate(cfg_name, smi, out_dir)
    return rows, by_path


# ------------------------------------------------------------------ phase 10


EVAL_SEED = 10
EVAL_PAIRS, EMD_POINTS = 8, 2048  # cd / emd / mmd pairs; the EMD pairs resampled to this size
CMP_POINTS, CMP_CLOUDS = 2048, 8  # card vs CPU: cd / mmd / TCD clouds resampled; clouds whose features are held
TCD_MAX_POINTS = 16384  # evaluate_temporal's --max-points
CHAMFER_POINTS, EMD_TIMED_POINTS = 32768, 26624  # a full scan; the EMD eval size of ops/emd.py
FEATURE_SET = (2000, 4096)  # Fréchet / MMD timing: an evaluation set of RangeNet-53 features
# card vs CPU limits: relative, except the engine's RBF mmd (a difference of
# kernel means near 1, held to 1e-4 of 1) and the feature matrices (relative
# L2); Fréchet distances in float64 on both sides; EMD's auction may break a
# near-tie the other way
EVAL_RTOL = {"cd": 1e-4, "jsd": 1e-4, "mmd": 1e-4, "tcd": 1e-4, "emd": 1e-3, "features": 1e-3, "frechet": 1e-3}
ICP_YAW_DEG, ICP_SHIFT, ICP_TOL_M = 3.0, (1.0, 0.5, 0.0), 0.05
ENGINE_METRICS = ("frd", "fpd", "jsd", "mmd")


def rollout_clouds(frames) -> list:
    """Each scene's frames of a rollout as host (N, 3) clouds, as
    ``sample_temporal`` writes them."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import frame_points
    from lidarcrafter_tpu_torch.training.factory import make_lidar_utils

    lu = make_lidar_utils(get_config("nuscenes-auto-reg-v2"), "cpu")
    return [[frame_points(f, s, lu) for f in frames] for s in range(frames[0].shape[0])]


def to_pixel_centres(cloud, H: int = 32, W: int = 1024, fov_up: float = 10.0, fov_down: float = -30.0):
    """``cloud`` turned by half a pixel in elevation and azimuth.  A frame's
    points lie on the ray angles of its range image, which are pixel edges,
    so projecting them again puts each on a bin edge, where an ulp between
    the card and the CPU flips its row; half a pixel on, they sit at pixel
    centres."""
    c = cloud.astype(np.float64)
    r = np.linalg.norm(c, axis=1)
    el = np.arcsin(c[:, 2] / r) - math.radians(fov_up - fov_down) / H / 2
    az = np.arctan2(c[:, 1], c[:, 0]) - math.pi / W
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1).astype(np.float32)


def resample(cloud, n: int, rnd) -> np.ndarray:
    return cloud[rnd.choice(len(cloud), n, replace=len(cloud) < n)]


def agrees(out: dict, name: str, card: float, cpu: float, tol: float, scale: float | None = None) -> None:
    """Card against CPU, relative to |CPU| (or to ``scale``), recorded in
    ``out`` with ``ok``; the phase fails after all are recorded."""
    err = abs(card - cpu) / (abs(cpu) if scale is None else scale)
    out[name] = {"card": card, "cpu": cpu, "err": err, "tol": tol, "ok": bool(np.isfinite(card) and err <= tol)}


def agrees_l2(out: dict, name: str, card, cpu, tol: float) -> None:
    """Card against CPU in relative L2 norm, recorded as :func:`agrees` does."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    err = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu)) if card.shape == cpu.shape else math.inf
    out[name] = {"shape": list(card.shape), "rel_l2_err": err, "tol": tol,
                 "ok": bool(np.isfinite(card).all() and err <= tol)}


def phase_evaluate(frames, smi: str) -> None:
    """Phase 10: the metric suite on the card over phase 6's float32 rollout
    (scenes 0-3 "real", 4-7 "gen", 16 frames each), with a RangeNet-53 and a
    PointNet of seeded weights; every metric again through the port on the
    CPU, on the same clouds and weights, held to ``EVAL_RTOL``."""
    import torch

    from lidarcrafter_tpu_torch.metrics import eval_suite, evaluate
    from lidarcrafter_tpu_torch.metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from lidarcrafter_tpu_torch.metrics.engine import EvaluationEngine
    from lidarcrafter_tpu_torch.metrics.extractor.pointnet import PointNetFeatureExtractor
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import RangeNet, to_rangenet_folder
    from lidarcrafter_tpu_torch.metrics.pretrained import pointnet_features, rangenet_lidargen
    from lidarcrafter_tpu_torch.metrics.temporal import icp_point_to_point, sequence_tcd
    from lidarcrafter_tpu_torch.ops.bev import point_cloud_to_histogram
    from lidarcrafter_tpu_torch.ops.chamfer import chamfer_metric
    from lidarcrafter_tpu_torch.ops.emd import emd_metric
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    scenes = rollout_clouds(frames)
    half = len(scenes) // 2
    real = [c for s in scenes[:half] for c in s]
    gen = [c for s in scenes[half:] for c in s]
    sizes = [len(c) for c in real + gen]
    rnd = np.random.RandomState(EVAL_SEED)
    seconds, agree, metrics = {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    rangenet = init_random_(RangeNet(num_classes=17, backbone=53), EVAL_SEED).eval()
    pointnet = init_random_(PointNetFeatureExtractor(), EVAL_SEED + 1).eval()
    extract = {"cpu": (rangenet_lidargen(rangenet), pointnet_features(pointnet)),
               DEVICE: (rangenet_lidargen(copy.deepcopy(rangenet).to(DEVICE)),
                        pointnet_features(copy.deepcopy(pointnet).to(DEVICE)))}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the engine on the card, then its metrics on the CPU from the card's cached features
        engine = EvaluationEngine(rangenet_apply=extract[DEVICE][0], pointnet_apply=extract[DEVICE][1],
                                  cache_dir=str(tmp / "cache"), device=DEVICE)
        card = timed("engine", lambda: engine.evaluate(real, gen, ENGINE_METRICS))
        cpu = timed("engine_cpu_from_card_features",
                    lambda: EvaluationEngine(cache_dir=str(tmp / "cache"), device="cpu").evaluate(real, gen,
                                                                                                  ENGINE_METRICS))
        check(list(card) == ["frd", "frd_mmd", "fpd", "fpd_mmd", "jsd", "mmd"], f"engine metrics {list(card)}")
        for k in card:
            tol = EVAL_RTOL["frechet"] if k[:3] in ("frd", "fpd") else EVAL_RTOL[k]
            agrees(agree, f"engine {k}", card[k], cpu[k], tol, scale=1.0 if k == "mmd" else None)
        metrics.update({f"engine_{k}": v for k, v in card.items()})
        # the features themselves, card vs CPU, from clouds at pixel centres; and the share of range-image
        # pixels that differ when the clouds are projected as they are
        subset = real[: CMP_CLOUDS // 2] + gen[: CMP_CLOUDS // 2]
        flips = [float((engine._range_input(torch.as_tensor(c, device=DEVICE)).cpu()
                        - EvaluationEngine(device="cpu")._range_input(torch.as_tensor(c))).abs().amax(1).gt(1e-5)
                       .float().mean()) for c in subset]
        agree["range input pixels differing, clouds as they are (reported)"] = {"share_max": max(flips), "ok": True}
        subset = [to_pixel_centres(c) for c in subset]
        feats = {dev: EvaluationEngine(rangenet_apply=a, pointnet_apply=b, device=dev).extract_features(subset, dev)
                 for dev, (a, b) in extract.items()}
        for k, dims in (("rangenet", 4096), ("pointnet", 1808), ("bev_hist", None)):
            check(dims is None or feats[DEVICE][k].shape == (len(subset), dims), f"{k} features {feats[DEVICE][k].shape}")
            agrees_l2(agree, f"{k} features", feats[DEVICE][k], feats["cpu"][k], EVAL_RTOL["features"])

        # evaluate(): cd and mmd on 8 aligned pairs at full size, emd on them resampled, jsd and frid on all
        folder = tmp / "pretrained" / "nuscenes" / "rangenet"
        folder.mkdir(parents=True)
        backbone, decoder = to_rangenet_folder(rangenet.state_dict())
        torch.save(backbone, folder / "backbone")
        torch.save(decoder, folder / "segmentation_decoder")
        root = str(tmp / "pretrained")
        pairs = real[:EVAL_PAIRS], gen[:EVAL_PAIRS]
        emd_pairs = tuple([resample(c, EMD_POINTS, rnd) for c in p] for p in pairs)
        kw = {"verbose": False, "device": DEVICE}
        card = timed("evaluate_cd_mmd", lambda: evaluate(*pairs, ["cd", "mmd"], **kw))
        card |= timed("evaluate_emd", lambda: evaluate(*emd_pairs, ["emd"], **kw))
        card |= timed("evaluate_jsd_frid", lambda: evaluate(real, gen, ["jsd", "frid"], pretrained_root=root, **kw))
        metrics.update(card)
        # the same on the CPU: cd / mmd on the pairs resampled to CMP_POINTS (on both devices), emd and jsd as
        # they are, frid from the card's descriptors in float64 and the descriptors on the subset
        cmp_pairs = tuple([resample(c, CMP_POINTS, rnd) for c in p] for p in pairs)
        on = {dev: evaluate(*cmp_pairs, ["cd", "mmd"], verbose=False, device=dev) for dev in (DEVICE, "cpu")}
        for k in ("cd", "mmd"):
            agrees(agree, f"{k} ({CMP_POINTS} points)", on[DEVICE][k], on["cpu"][k], EVAL_RTOL[k])
        cpu = timed("cpu_emd_jsd", lambda: evaluate(*emd_pairs, ["emd"], verbose=False, device="cpu")
                    | evaluate(real, gen, ["jsd"], verbose=False, device="cpu"))
        for k in ("emd", "jsd"):
            agrees(agree, k, card[k], cpu[k], EVAL_RTOL[k])
        descs = [eval_suite._range_descriptors(c, "32", root, device=DEVICE) for c in (real, gen)]
        agrees(agree, "frid", card["frid"], compute_frechet_distance(*[d.cpu() for d in descs], device="cpu"),
                     EVAL_RTOL["frechet"])
        sub = {dev: eval_suite._range_descriptors(subset, "32", root, device=dev).cpu().numpy() for dev in extract}
        agrees_l2(agree, "frid descriptors", sub[DEVICE], sub["cpu"], EVAL_RTOL["features"])

    # TCD of each scene's 16 frames, as evaluate_temporal subsamples them; card vs CPU on scene 0 resampled
    cli_rng = np.random.default_rng(0)
    tcd = timed("tcd", lambda: [sequence_tcd([c if len(c) <= TCD_MAX_POINTS else
                                               c[cli_rng.choice(len(c), TCD_MAX_POINTS, replace=False)] for c in s],
                                              device=DEVICE) for s in scenes])
    metrics["tcd"] = {f"split_{k}": float(np.mean([v for t in tcd for v in t[k]])) for k in tcd[0]}
    seq = [resample(c, CMP_POINTS, rnd) for c in scenes[0]]
    on = {dev: sequence_tcd(seq, device=dev) for dev in (DEVICE, "cpu")}
    worst = max(abs(a - b) / abs(b) for k in on["cpu"] for a, b in zip(on[DEVICE][k], on["cpu"][k]))
    agree[f"tcd ({CMP_POINTS} points)"] = {"pairs": sum(map(len, on["cpu"].values())), "worst_rel_err": worst,
                                           "tol": EVAL_RTOL["tcd"], "ok": worst <= EVAL_RTOL["tcd"]}

    # ICP recovers a rigid motion of a rollout frame
    src = torch.as_tensor(scenes[0][0], device=DEVICE)
    yaw = math.radians(ICP_YAW_DEG)
    R = torch.tensor([[math.cos(yaw), -math.sin(yaw), 0.0], [math.sin(yaw), math.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     device=DEVICE)
    shift = torch.tensor(ICP_SHIFT, device=DEVICE)
    R_est, t_est = timed("icp", lambda: icp_point_to_point(src, src @ R.T + shift))
    icp = {"points": len(src), "t_est": t_est.tolist(), "t_err_m": float((t_est - shift).abs().max()),
           "R_err": float((R_est - R).abs().max()), "tol_m": ICP_TOL_M}
    check(icp["t_err_m"] <= ICP_TOL_M, f"ICP: translation off by {icp['t_err_m']:.3g} m > {ICP_TOL_M}")

    # device times (CUDA events)
    cloud = torch.as_tensor(real[0], device=DEVICE)
    pts = torch.as_tensor(engine._subsample(real[0]), device=DEVICE)[None]
    img = engine._range_input(cloud)
    x, y = (torch.as_tensor(resample(c, CHAMFER_POINTS, rnd), device=DEVICE)[None] for c in (real[0], gen[0]))
    e1, e2 = (torch.as_tensor(resample(c, EMD_TIMED_POINTS, rnd), device=DEVICE)[None] for c in (real[0], gen[0]))
    lo, span = torch.minimum(e1.amin(1), e2.amin(1)), torch.maximum(e1.amax(1), e2.amax(1))
    e1, e2 = ((e - lo) / (span - lo).max() for e in (e1, e2))  # EMD's convention: the unit cube
    with torch.inference_mode():
        times = {"rangenet53_features_ms_per_cloud": time_ms(lambda: extract[DEVICE][0](img), iters=10),
                 "pointnet_features_ms_per_cloud": time_ms(lambda: extract[DEVICE][1](pts)),
                 "bev_histogram_ms_per_cloud": time_ms(lambda: point_cloud_to_histogram(cloud)),
                 f"chamfer_ms_{CHAMFER_POINTS}x{CHAMFER_POINTS}": time_ms(lambda: chamfer_metric(x, y), iters=3,
                                                                          warmup=1),
                 f"emd_ms_{EMD_TIMED_POINTS}": time_ms(lambda: emd_metric(e1, e2), iters=1, warmup=0)}
    f1, f2 = (torch.as_tensor(a, device=DEVICE) for a in
              np.random.RandomState(EVAL_SEED).standard_normal((2, *FEATURE_SET)).astype(np.float32))
    f2 = f2 * 1.1 + 0.1
    fd = timed(f"frechet_{FEATURE_SET[0]}x{FEATURE_SET[1]}", lambda: compute_frechet_distance(f1, f2, device=DEVICE))
    mmd = timed(f"squared_mmd_{FEATURE_SET[0]}x{FEATURE_SET[1]}", lambda: compute_squared_mmd(f1, f2, device=DEVICE))
    check(np.isfinite(fd) and fd > 0 and np.isfinite(mmd), f"Fréchet / MMD of the timing set: {fd}, {mmd}")
    launches = {k: c.n for k, c in counters.items()}
    failed = {k: v for k, v in agree.items() if not v["ok"]}
    check(not failed, f"evaluate card vs CPU: {failed}")
    check(all(n == 0 for n in launches.values()), f"evaluate: a kernel of the port launched: {launches}")
    for k, v in metrics.items():
        check(all(np.isfinite(list(v.values()) if isinstance(v, dict) else [v])), f"evaluate: {k} is {v}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "evaluate", "card": smi, "clouds": {"real": len(real), "gen": len(gen), "points_min": min(sizes),
                                                        "points_max": max(sizes), "points_mean": float(np.mean(sizes))},
          "extractors": "RangeNet-53 (32x1024, 4096 features) and PointNet (k=16, 2048 points), seeded weights",
          "metrics": metrics, "card_vs_cpu": agree, "icp": icp, "device_ms": times, "seconds": seconds,
          "frechet_timing_set": fd, "squared_mmd_timing_set": mmd, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
# every other image-generation config of the registry ("zoo")

ZOO = ("nuscenes-box-layout", "nuscenes-box-layout-v5", "nuscenes-auto-reg", "kitti-360", "nuscenes-hdit-uncond")
ZOO_REQUEST = ("dpmpp_2m", 15)
V0_OACA_PER_FORWARD = 6  # ds4: 2 down + mid + 3 up
REPAINT = dict(num_steps=10, num_resample_steps=2, jump_length=2)  # 40 denoiser calls
DISCRETE_STEPS = 50


def kernel_modules(model) -> dict:
    """Kernel launches per denoiser call, from the modules the forward
    holds: one OACA per ``ObjectAwareCrossAttention``, one attention per
    EfficientUNet attention block, one GroupNorm per norm module."""
    from lidarcrafter_tpu_torch.models.layout_unet import ObjectAwareCrossAttention
    from lidarcrafter_tpu_torch.models.ops import FusedGN, MFSelfAttention2d, SelfAttention2d

    def count(*cls):
        return sum(isinstance(m, cls) for m in model.modules())

    return {"oaca": count(ObjectAwareCrossAttention), "attention": count(SelfAttention2d, MFSelfAttention2d),
            "groupnorm": count(FusedGN)}


def zoo_generator(cfg_name: str, dtype, cfg=None):
    """The config's generator (``CondFrameGenerator`` or
    ``UncondFrameGenerator``) on the card, seeded random weights, and a
    request function ``(steps, mode, seed) -> (sample, post)`` at B=8; the
    v5 stack is served from a batch built here, as a caller would."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator

    cfg = cfg or get_config(cfg_name)
    if cfg.condition_model is None:
        gen = UncondFrameGenerator(cfg, DEVICE, 0, dtype)
        return gen, gen.model, lambda steps, mode, seed: gen.generate(BATCH, steps, mode=mode, seed=seed)
    gen = CondFrameGenerator(cfg, DEVICE, 0, dtype)
    batch = None
    if cfg.condition_model.architecture == "layout_encoder_v5":
        batch = condition_batch(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(5), DEVICE)
    return gen, gen.models["model"], lambda steps, mode, seed: gen.generate(BATCH, steps, mode=mode, seed=seed,
                                                                           batch=batch)


def zoo_request(what: str, run, warmup, per_call: dict, calls: int, smi: str, **extra) -> tuple[dict, tuple]:
    """``run()`` after ``warmup()``, the launch counters set to 0 just
    before and read just after; each kernel must have launched
    ``per_call[kernel]`` times in each of the request's ``calls`` denoiser
    calls.  Emits the line; returns the counts and ``run``'s (sample,
    post)."""
    import torch

    warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    sample, post = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    for k, n in launches.items():
        check(n == per_call.get(k, 0) * calls, f"{what}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    check(bool(torch.isfinite(sample).all()) and bool(torch.isfinite(post["xyz"]).all()), f"{what}: not finite")
    check(float(sample.std()) > 1e-3, f"{what}: sample is constant")
    emit({"phase": "zoo", "what": what, "card": smi, "batch": BATCH, "denoiser_calls": calls, "seconds": seconds,
          "frames_per_s": BATCH / seconds, "ms_per_call": seconds * 1e3 / calls, "launches": launches,
          "per_call": per_call, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_std": float(sample.std()), **extra})
    return {k: n for k, n in launches.items() if n}, (sample, post)


def zoo_call(gen, cfg):
    """One denoiser call (x̂_0 at t = 0.5, B=8) of a zoo generator."""
    import torch

    H, W = cfg.data.resolution
    x = torch.randn(BATCH, H, W, 2, device=DEVICE)
    t = torch.full((BATCH,), 0.5, device=DEVICE)
    if cfg.condition_model is None:
        return lambda: gen.engine.predict_x_0(x, t)
    with torch.inference_mode():
        cond = gen.engine.get_network_condition(
            condition_batch(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(6), DEVICE))
    return lambda: gen.engine.predict_x_0(x, t, cond)


def phase_zoo(smi: str) -> dict:
    """Phase 11: the v0 stack, v5, the 12-channel auto-reg stack, kitti-360
    and HDiT at full width: card-vs-CPU forwards, one B=8 DPM++(2M)@15
    request each in float32 and in bfloat16 through the entry points with
    exact launch counts, a profile of a v0 and an HDiT call, then one
    RePaint and one ``DiscreteDiffusion`` request on the uncond stack.
    Returns the launch counts by path."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.diffusion import schedules

    by_path = {}
    for name in ZOO:
        t0 = time.perf_counter()
        if get_config(name).condition_model is None:
            phase_unet_forward_parity(name)
        else:
            phase_forward_parity(name)
        emit({"phase": "zoo", "what": f"{name} forward parity", "seconds": time.perf_counter() - t0})
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            gen, model, request = zoo_generator(name, dtype)
            per_call = kernel_modules(model)
            if name == "nuscenes-box-layout":
                check(per_call["oaca"] == V0_OACA_PER_FORWARD, f"v0: {per_call['oaca']} OACA blocks")
                heads = {(m.num_heads, m.qkv_projector.in_features // m.num_heads) for m in model.modules()
                         if hasattr(m, "qkv_projector")}
                check(heads == {(8, 64)}, f"v0 OACA heads x head dim {heads}, expected 8 x 64")
            if name == "nuscenes-hdit-uncond":
                check(not any(per_call.values()), f"HDiT holds kernel modules {per_call}")
            mode, steps = ZOO_REQUEST
            by_path[f"zoo {name} {dname}"], _ = zoo_request(
                f"{name} {dname} {mode}@{steps}", lambda: request(steps, mode, 1), lambda: request(2, mode, 99),
                per_call, steps, smi, config=name, dtype=dname)
            if dtype == torch.float32 and name in ("nuscenes-box-layout", "nuscenes-hdit-uncond"):
                expect = {"groupnorm kernel": per_call["groupnorm"], "oaca kernel": per_call["oaca"],
                          "attention kernel": per_call["attention"]}
                phase_profile(f"one denoiser call ({name}, predict_x_0), B=8, {dname}", zoo_call(gen, gen.cfg),
                              smi, expect=expect)
            del gen, model, request
            torch.cuda.empty_cache()

    # RePaint and DiscreteDiffusion on the uncond stack (float32)
    cfg = get_config("nuscenes-unet-uncond")
    gen, model, request = zoo_generator("nuscenes-unet-uncond", torch.float32, cfg)
    per_call = kernel_modules(model)
    known, _ = request(ZOO_REQUEST[1], ZOO_REQUEST[0], 3)
    known = known.clamp(-1, 1)
    mask = torch.zeros_like(known)
    mask[:, ::2] = 1  # every other beam known: complete the rest
    calls = REPAINT["num_steps"] * REPAINT["num_resample_steps"] * REPAINT["jump_length"]
    by_path["zoo repaint nuscenes-unet-uncond float32"], (filled, _) = zoo_request(
        "repaint nuscenes-unet-uncond float32", lambda: gen.inpaint(known, mask, seed=1, **REPAINT),
        lambda: gen.inpaint(known, mask, 1, seed=99), per_call, calls, smi,
        config="nuscenes-unet-uncond", dtype="float32", **REPAINT)
    # the last paste is the known region noised to t = 0: known·α(0) + σ(0)·z
    alpha0, sigma0 = schedules.log_snr_to_alpha_sigma(gen.engine.log_snr(torch.zeros(1)))
    held_tol = float(1 - alpha0) + 6 * float(sigma0)
    held = float((filled - known)[mask > 0].abs().max())
    check(held <= held_tol, f"repaint: known region off by {held} > {held_tol}")
    emit({"phase": "zoo", "what": "repaint known region", "max_abs_dev": held, "tol": held_tol,
          "filled_std": float(filled[mask == 0].std())})
    del gen, model, request
    cfg = get_config("nuscenes-unet-uncond")
    cfg.diffusion.timestep_type = "discrete"
    cfg.diffusion.num_training_steps = 1000  # the registry leaves it None; the engine needs its table length
    gen, model, request = zoo_generator("nuscenes-unet-uncond", torch.float32, cfg)
    check(type(gen.engine).__name__ == "DiscreteDiffusion", f"discrete engine: {type(gen.engine).__name__}")
    by_path["zoo discrete nuscenes-unet-uncond float32"], _ = zoo_request(
        f"discrete nuscenes-unet-uncond float32 ddpm@{DISCRETE_STEPS}", lambda: request(DISCRETE_STEPS, "ddpm", 1),
        lambda: request(2, "ddpm", 99), per_call, DISCRETE_STEPS, smi, config="nuscenes-unet-uncond",
        dtype="float32", num_training_steps=gen.engine.num_training_steps)
    del gen, model, request
    torch.cuda.empty_cache()
    return by_path


def probe_times(kernels) -> dict:
    """Device times of the loader's ``x·2`` probe kernel on its (8, 128)
    float32 input, of ``x * 2`` and of ``torch.mul(x, 2)``, and its bound
    (x read and y written once)."""
    import torch

    from lidarcrafter_tpu_torch.kernels import loader

    lib = kernels.libs["probe"]
    x = torch.arange(8 * 128, dtype=torch.float32, device=DEVICE).reshape(8, 128)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        loader.check(lib.probe_x2(x.data_ptr(), y.data_ptr(), x.numel(), stream), "probe_x2")

    ms = time_ms(launch)
    check(torch.equal(y, x * 2), "probe_x2 returned wrong values")
    nbytes = 2 * x.numel() * x.element_size()
    bound, by = bound_ms(nbytes, x.numel(), GN_ROUTE)
    return {"probe_ms": ms, "probe_plain_ms": time_ms(lambda: x * 2),
            "probe_library_ms": time_ms(lambda: torch.mul(x, 2)), "probe_bound_ms": bound,
            "probe_bound_by": by, "probe_bytes": nbytes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port runs on the card", file=sys.stderr)
        return 2
    if not (REPO / "lidarcrafter_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no lidarcrafter_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lidarcrafter_tpu_torch.kernels import loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    kernels = loader.load_kernels()  # builds, loads and runs the x·2 probe (raises on failure)
    load_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kernels.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_seconds": kernels.build_seconds, "load_and_probe_seconds": load_s,
          "probe": "x*2 ok", **probe_times(kernels), "ptxas": ptxas})

    rows = phase_kernels()
    phase_forward_parity("nuscenes-box-layout-v6")
    phase_unet_forward_parity("nuscenes-unet-uncond")
    counts = {
        "nuscenes-box-layout-v6": {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD},
        "nuscenes-unet-uncond": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
        "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    }
    # float32: DDIM@50 + DPM++@15 (MeanFlow one step); bfloat16: one DPM++@15
    # request (MeanFlow one step) per path, served by its own generators
    requests = {
        "float32": {name: (("meanflow", 1),) if name == "meanflow-nusc" else REQUESTS for name in counts},
        "bfloat16": {name: (("meanflow", 1),) if name == "meanflow-nusc" else (("dpmpp_2m", 15),)
                     for name in counts},
    }
    by_path = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        gens = build_generators(dtype)
        for name in counts:
            by_path[f"{name} {dname}"] = phase_main_path(name, gens[name], counts[name],
                                                         requests[dname][name], smi)
        calls = profile_calls(gens["nuscenes-box-layout-v6"], gens["nuscenes-unet-uncond"])
        for path, norms in (("layout", GN_PER_FORWARD), ("uncond", GN_PER_UNET)):
            phase_profile(f"one denoiser call ({path}, predict_x_0), B=8, {dname}", calls[path], smi,
                          expect={"groupnorm kernel": norms})
        del gens, calls
        torch.cuda.empty_cache()
        by_path[f"rollout {dname}"], frames = phase_rollout(dtype, smi)
        if dtype == torch.float32:
            rollout_frames = frames  # phase 10 evaluates them
        del frames
        torch.cuda.empty_cache()
    backward_rows, train_paths = phase_train(smi)
    by_path.update(train_paths)
    by_path["layout nuscenes-layout float32"] = phase_layout(smi)
    phase_object(smi)
    jvp_rows, branch_paths = phase_branch_train(smi)
    by_path.update(branch_paths)
    phase_evaluate(rollout_frames, smi)
    by_path.update(phase_zoo(smi))

    # each kernel at its largest main-path shape, float32 (the default serving
    # dtype) with its bfloat16 numbers beside, and its launches summed over
    # the paths and dtypes that run it
    sources = {
        "oaca": ("lidarcrafter_tpu_torch/csrc/oaca.cu", "lidarcrafter_tpu/ops/pallas_attention.py:183"),
        "groupnorm": ("lidarcrafter_tpu_torch/csrc/groupnorm.cu", "lidarcrafter_tpu/ops/pallas_groupnorm.py:49"),
        "attention": ("lidarcrafter_tpu_torch/csrc/attention.cu", "lidarcrafter_tpu/ops/pallas_attention.py:40"),
    }
    kernels = []
    backward_keys = ("ms", "plain_ms", "library_ms", "library", "bound_ms", "bound_by", "max_abs_err", "rel_err",
                     "norm_rel_err", "shape", "route")
    for k, (source, replaces) in sources.items():
        first = next(r for r in rows if r["kernel"] == k and r["dtype"] == "float32")
        bf16 = next(r for r in rows if r["kernel"] == k and r["dtype"] == "bfloat16"
                    and r["shape"] == first["shape"])
        bwd = {d: next(r for r in backward_rows if r["kernel"].split()[0] == k and r["dtype"] == d)
               for d in ("float32", "bfloat16")}
        paths = {p: n[k] for p, n in by_path.items() if k in n}
        check(all(n > 0 for n in paths.values()), f"{k}: a path that runs it did not launch it: {paths}")
        jvp = {d: next((r for r in jvp_rows if r["kernel"] == k and r["dtype"] == d), None)
               for d in ("float32", "bfloat16")}
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": first["max_abs_err"], "tol": first["tol"], "norm_rel_err": first["norm_rel_err"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shape": first["shape"], "dtype": "float32",
            "core_route": first["route"],
            "bf16": {key: bf16[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                "max_abs_err", "tol", "norm_rel_err", "route")},
            "backward": {key: bwd["float32"][key] for key in backward_keys}
            | {"bf16": {key: bwd["bfloat16"][key] for key in backward_keys}},
            # OACA's second instantiation, head dims 64 (the v0 stack)
            **({"head_dims_64": {d: {key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "max_abs_err", "norm_rel_err", "route")}
                                 for d in ("float32", "bfloat16") for r in rows
                                 if r["kernel"] == k and r.get("head_dims") == [64, 64, 64] and r["dtype"] == d
                                 and "ds4" in r["shape"]}} if k == "oaca" else {}),
            # the forward-mode route, where a path takes one (OACA has none)
            "jvp": None if jvp["float32"] is None else {key: jvp["float32"][key] for key in backward_keys}
            | {"bf16": {key: jvp["bfloat16"][key] for key in backward_keys}},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
