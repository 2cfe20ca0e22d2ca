"""The port's CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach (ragged query tiles that are no multiple
of 16 or 64, layout strips of 0, 1, 13 and 64 tokens, odd channel counts,
tiny groups, masked key tails inside the first 16 keys, head dims 8-512 with
dqk != dv, logits near +-30), and the wrappers refusing what the kernels do
not take.  Marked ``cuda``; without a card they skip.  Run them on the card
with ``python -m pytest tests/test_torch_port_cuda.py``.

Tolerances as in ``chip_smoke.py``: float32 to 1e-4 and bfloat16 to 2e-2 of
max(1, max |plain|), and the error's norm to 1e-3 (float32) and 1e-2
(bfloat16) of the plain output's norm, which catches a fault on a few
percent of the keys where most outputs are far below 1.
"""

import copy
import itertools
import math

import pytest
import torch

from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.float().abs().max()))


def _assert_close(got, want, dtype):
    assert _rel_err(got, want) <= TOL[dtype]
    assert float((got.float() - want.float()).norm()) <= NORM_TOL[dtype] * float(want.float().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,L,L2", [(1, 1, 1, 1), (2, 3, 100, 13), (1, 2, 64, 64), (3, 1, 130, 0), (1, 2, 1000, 13), (2, 1, 77, 1)]
)
def test_oaca_kernel_matches_plain(gen, dtype, B, H, L, L2):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    ops = (r(B, H, L, 32), r(B, H, L, 32), r(B, H, L, 32), r(B, H, L2, 64), r(B, H, L, 32), r(B, H, L2, 32))
    scale = 1 / math.sqrt(math.sqrt(64))
    n = oaca.launches.n
    got = oaca.oaca_attention(*ops, scale=scale)
    torch.cuda.synchronize()
    assert oaca.launches.n == n + 1
    want = oaca.oaca_attention_plain(*ops, scale=scale)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp", [16, 64])
@pytest.mark.parametrize("B,H,L,L2", [(1, 1, 1, 1), (2, 3, 100, 13), (3, 1, 130, 0), (2, 8, 2048, 13)])
def test_oaca_kernel_positional_widths_match_plain(gen, dtype, dp, B, H, L, L2):
    """``channels_scale_for_positional_embedding`` 0.5 and 2 on 32-channel
    heads: positional head dims 16 (the 32-wide build, zero-filled) and 64."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    ops = (r(B, H, L, 32), r(B, H, L, dp), r(B, H, L, 32), r(B, H, L2, 32 + dp), r(B, H, L, 32), r(B, H, L2, 32))
    scale = 1 / math.sqrt(math.sqrt(32 + dp))
    n = oaca.launches.n
    got = oaca.oaca_attention(*ops, scale=scale)
    torch.cuda.synchronize()
    assert oaca.launches.n == n + 1
    want = oaca.oaca_attention_plain(*ops, scale=scale)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


def test_oaca_kernel_refuses_head_dims_it_was_not_built_for(gen):
    ops = [torch.zeros(1, 1, 8, 16, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError, match="head dims"):
        oaca.oaca_attention(ops[0], ops[1], ops[2], torch.zeros(1, 1, 2, 32, device="cuda"),
                            ops[0], torch.zeros(1, 1, 2, 16, device="cuda"), scale=1.0)


def _gn_edge_hw(edge: str, side: str, C: int, G: int, dtype) -> int:
    """HW of a (2, HW, C) norm just below / above one of the kernel's
    thresholds: ``grid`` (one block an image -> blocks merged after a grid
    sync) or ``staged`` (every row of a block in shared memory -> one row a
    block re-read from L2)."""
    elt = torch.finfo(dtype).bits // 8
    sms = groupnorm._num_sms(0)

    def plan(hw):
        return groupnorm.plan(2, hw, C, G, elt, sms)

    if edge == "grid":
        hw = next(hw for hw in itertools.count(1) if plan(hw).k > 1)
        return hw - 1 if side == "below" else hw
    k = sms // 2
    cap = plan(1 << 20).stage_rows
    hw = k * (cap if side == "below" else cap + 1)
    assert plan(hw).k == k and plan(hw).read_once == (side == "below")
    return hw


# ops: "folded" is the call form of the earlier wrapper, gamma and beta in
# f32, (1, C) or (B, C) per ``per_batch``; "raw" is the modules' form, the
# norm's (C,) weight and bias with the strided ``chunk`` halves of a (B, 2C)
# projection as scale and shift, all in x's dtype; "raw-none" has no weight
# and no bias (AdaGN).  A ``shape[1]`` of ("grid" | "staged", side) is an edge.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,per_batch,silu,ops,groups",
    [((2, 13, 64), False, False, "folded", 32), ((1, 1, 32), False, True, "folded", 32),
     ((3, 7, 9, 96), True, True, "folded", 32), ((2, 5, 1024), True, False, "folded", 32),
     ((2, 4000, 192), False, True, "folded", 32),
     ((2, 64, 128, 64), False, True, "raw", 32), ((3, 7, 9, 96), False, True, "raw-none", 32),
     ((8, 13, 64), False, False, "raw", 32), ((1, 4, 128, 1024), False, True, "raw", 512),
     ((2, 8, 128, 512), False, True, "raw-none", 8),
     ((2, 300, 100), False, True, "raw", 20),  # bf16 C % 8 == 4: 8-byte pieces, cp.async staging
     ((2, 1000, 100), False, False, "raw-none", 4),
     ((2, ("grid", "below"), 64), False, True, "raw", 32),
     ((2, ("grid", "above"), 64), False, True, "raw", 32),
     ((2, ("staged", "below"), 64), False, True, "raw", 32),
     ((2, ("staged", "above"), 64), False, True, "raw", 32)],
)
def test_groupnorm_kernel_matches_plain(gen, dtype, shape, per_batch, silu, ops, groups):
    if isinstance(shape[1], tuple):
        shape = (shape[0], _gn_edge_hw(*shape[1], shape[-1], groups, dtype), shape[-1])
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 5).to(dtype)
    if ops == "folded":
        rows = B if per_batch else 1
        weight = 1 + 0.1 * torch.randn(rows, C, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(rows, C, generator=gen, device="cuda")
        scale = shift = None
    else:
        weight = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        bias = (0.1 * torch.randn(C, generator=gen, device="cuda")).to(dtype)
        if ops == "raw-none":
            weight = bias = None
        scale, shift = (0.3 * torch.randn(B, 2 * C, generator=gen, device="cuda")).to(dtype).chunk(2, dim=-1)
    args = dict(num_groups=groups, eps=1e-5, silu=silu, scale=scale, shift=shift)
    n = groupnorm.launches.n
    got = groupnorm.group_norm(x, weight, bias, **args)
    torch.cuda.synchronize()
    assert groupnorm.launches.n == n + 1
    want = groupnorm.group_norm_plain(x, weight, bias, **args)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 1024, 64), (8, 13, 64), (8, 4, 128, 1024)])
def test_groupnorm_kernel_is_deterministic_and_one_launch(gen, dtype, shape):
    """Two calls on one input are bit-identical (the blocks' partials merge
    in a fixed order, no float atomics), and a profiler trace of one call
    shows exactly one device kernel.  The call is traced after one warm-up
    cycle of the trace: the first cycle can miss a kernel that starts
    before the device tracing runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    C = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w, b = torch.randn(C, generator=gen, device="cuda"), torch.randn(C, generator=gen, device="cuda")
    s, t = torch.randn(shape[0], 2 * C, generator=gen, device="cuda").chunk(2, dim=-1)
    args = dict(num_groups=32, eps=1e-5, scale=s, shift=t, silu=True)
    first = groupnorm.group_norm(x, w, b, **args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            second = groupnorm.group_norm(x, w, b, **args)
            torch.cuda.synchronize()
            prof.step()
    assert torch.equal(first, second)
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "gn_fused_kernel" in kernels[0], kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,Lq,Lkv,kv_len,dqk,dv",
    [(2, 8, 512, 512, None, 64, 64), (1, 3, 100, 100, None, 32, 32), (2, 2, 64, 128, 77, 128, 128),
     (1, 1, 1, 1, None, 8, 8), (3, 2, 130, 65, 65, 48, 24), (1, 2, 200, 256, 1, 16, 128),
     (2, 2, 77, 128, 9, 64, 64), (1, 4, 300, 300, None, 64, 32), (2, 1, 50, 700, 640, 32, 128)],
)
def test_attention_kernel_matches_plain(gen, dtype, B, H, Lq, Lkv, kv_len, dqk, dv):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = r(B, H, Lq, dqk), r(B, H, Lkv, dqk), r(B, H, Lkv, dv)
    scale = 1 / math.sqrt(dqk)
    n = attention.launches.n
    got = attention.attention(q, k, v, scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert attention.launches.n == n + 1
    want = attention.attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,Lq,Lkv,kv_len,dqk,dv",
    [(2, 1, 300, 300, None, 256, 256), (1, 2, 77, 130, 100, 384, 384), (2, 1, 200, 513, 9, 512, 512),
     (1, 1, 64, 64, None, 512, 128), (1, 2, 100, 70, None, 128, 256), (1, 1, 1, 1, None, 160, 160),
     (2, 2, 130, 143, 140, 256, 384)],
)
def test_attention_kernel_wide_heads_match_plain(gen, dtype, B, H, Lq, Lkv, kv_len, dqk, dv):
    """Head dims above 128 (the wide route: 128-wide chunks of dqk, slices
    of dv), ragged query and key tiles and a ``kv_len`` mask."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = r(B, H, Lq, dqk), r(B, H, Lkv, dqk), r(B, H, Lkv, dv)
    scale = 1 / math.sqrt(dqk)
    n = attention.launches.n
    got = attention.attention(q, k, v, scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert attention.launches.n == n + 1
    want = attention.attention_plain(q, k, v, scale=scale, kv_len=kv_len)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_reads_glide_views(gen, dtype):
    """GLIDE's operands: per-head views of one projection packed per head as
    [q|k|v], the encoder's 13 tokens' K/V in front of the image's; the same
    output as contiguous copies, and as the plain version."""
    B, L, H, d = 2, 300, 4, 32
    qkv = torch.randn(B, L, H * 3 * d, generator=gen, device="cuda").to(dtype).view(B, L, H, 3 * d)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    ekv = torch.randn(B, 13, H * 2 * d, generator=gen, device="cuda").to(dtype).view(B, 13, H, 2 * d)
    ek, ev = (t.transpose(1, 2) for t in ekv.split(d, dim=-1))
    k, v = torch.cat([ek, k], dim=2), torch.cat([ev, v], dim=2)
    got = attention.attention(q, k, v, scale=d**-0.5)
    same = attention.attention(q.contiguous(), k, v, scale=d**-0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, same, rtol=0, atol=0)
    _assert_close(got, attention.attention_plain(q, k, v, scale=d**-0.5), dtype)


def test_attention_kernel_reads_strided_head_views(gen):
    """Per-head views of one (B, L, 3C) projection, as ``SelfAttention2d``
    hands them, give the same output as contiguous copies."""
    B, L, C, nh = 2, 300, 256, 4
    qkv = torch.randn(B, L, 3 * C, generator=gen, device="cuda")
    heads = [t.reshape(B, L, nh, C // nh).transpose(1, 2) for t in qkv.split(C, -1)]
    got = attention.attention(*heads, scale=0.125)
    want = attention.attention(*(t.contiguous() for t in heads), scale=0.125)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()  # written in (B, L, heads, dv) order
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["attention", "oaca"])
def test_float32_kernels_hold_1e4_at_logits_near_30(gen, kernel):
    """Logits of |s| up to ~30-40: TF32 alone (10 mantissa bits) would miss
    1e-4 by two orders; the 3xTF32 split keeps ~22 bits."""
    B, H, L = 2, 2, 200
    c = 10.0 ** 0.5  # q, k entries ~ N(0, 10): logits ~ N(0, 100) at scale 1/sqrt(dh), dh = 64
    if kernel == "attention":
        q, k = (c * torch.randn(B, H, L, 64, generator=gen, device="cuda") for _ in range(2))
        v = torch.randn(B, H, L, 64, generator=gen, device="cuda")
        got = attention.attention(q, k, v, scale=1 / 8)
        want = attention.attention_plain(q, k, v, scale=1 / 8)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / 8
    else:
        q_c, ipe, k_c = (c * torch.randn(B, H, L, 32, generator=gen, device="cuda") for _ in range(3))
        k_l = c * torch.randn(B, H, 13, 64, generator=gen, device="cuda")
        v_c, v_l = torch.randn(B, H, L, 32, generator=gen, device="cuda"), torch.randn(B, H, 13, 32,
                                                                                       generator=gen, device="cuda")
        scale = 1 / math.sqrt(math.sqrt(64))
        got = oaca.oaca_attention(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale)
        want = oaca.oaca_attention_plain(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale)
        logits = torch.einsum("bhqd,bhkd->bhqk", torch.cat([q_c, ipe], -1), torch.cat([k_c, ipe], -1)) / 8
    torch.cuda.synchronize()
    assert float(logits.abs().max()) > 30
    _assert_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_views_that_are_not_16_byte_aligned(gen, dtype):
    wide = torch.randn(1, 2, 64, 65, generator=gen, device="cuda").to(dtype)
    bad = wide[..., 1:]  # 64 columns starting one element in: pointer and strides off 16 bytes
    ok = torch.randn(1, 2, 64, 64, generator=gen, device="cuda").to(dtype)
    n = attention.launches.n
    with pytest.raises(ValueError, match="16-byte"):
        attention.attention(bad, ok, ok, scale=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        attention.attention(ok, ok, bad, scale=1.0)
    assert attention.launches.n == n
    half = lambda t: t[..., :32]  # noqa: E731  aligned 32-column views
    n = oaca.launches.n
    with pytest.raises(ValueError, match="16-byte"):
        oaca.oaca_attention(half(bad), half(ok), half(ok), ok[:, :, :13], half(ok), half(ok)[:, :, :13], scale=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        oaca.oaca_attention(half(ok), half(ok), half(ok), bad[:, :, :13], half(ok), half(ok)[:, :, :13], scale=1.0)
    assert oaca.launches.n == n


def test_attention_kernel_refuses_head_dims_above_128(gen):
    """Head dims above 128 take the wide route up to 512 and are refused
    above it, naming the limit; a width that is no whole number of 16-byte
    pieces is refused at any size."""
    q = torch.zeros(1, 1, 8, 516, device="cuda")
    n = attention.launches.n
    with pytest.raises(ValueError, match="head dims <= 512"):
        attention.attention(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="head dims <= 512"):
        attention.attention(q[..., :64], q[..., :64], q, scale=1.0)
    odd = torch.zeros(1, 1, 8, 129, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        attention.attention(odd, odd, odd, scale=1.0)
    assert attention.launches.n == n


# ------------------------------------------------------ the rollout geometry
#
# The projection, the split and the refine on the card against the same
# functions on the CPU, at the rollout's size (8 scenes of 32·1024 + 13·512
# = 39,424 points, 13 boxes).  Points sit at random pixel centres (at most
# 0.4 px off) and away from box faces, so that an ulp of arcsin / atan2 /
# cos between the CPU and the card moves none across an edge: integer and
# bool outputs must match exactly, floats to 1e-5 of max(1, max |CPU|).

ROLLOUT_S, ROLLOUT_N, ROLLOUT_K = 8, 32 * 1024 + 13 * 512, 13
GEOM_RTOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    rnd = np.random.RandomState(0)
    S, N, K, Hh, Ww = ROLLOUT_S, ROLLOUT_N, ROLLOUT_K, 32, 1024
    up, down = math.radians(10.0), math.radians(-30.0)
    h = rnd.randint(0, Hh, (S, N)) + 0.5 + rnd.uniform(-0.4, 0.4, (S, N))
    w = rnd.randint(0, Ww, (S, N)) + 0.5 + rnd.uniform(-0.4, 0.4, (S, N))
    elev = (1.0 - h / Hh) * (up - down) - abs(down)
    azim = (2.0 * w / Ww - 1.0) * np.pi
    r = rnd.uniform(2.0, 40.0, (S, N))
    xyz = np.stack([r * np.cos(elev) * np.cos(-azim), r * np.cos(elev) * np.sin(-azim), r * np.sin(elev)], -1)
    boxes = np.concatenate([
        rnd.uniform(-20, 20, (S, K, 2)), rnd.uniform(-1, 1, (S, K, 1)), rnd.uniform(1, 5, (S, K, 3)),
        rnd.uniform(-np.pi, np.pi, (S, K, 1)), rnd.randint(1, 9, (S, K, 1)),
    ], -1)
    # box-local coordinates in float64: drop points within 1e-3 m of a face
    shift = xyz[:, None] - boxes[:, :, None, :3]
    c, s = np.cos(-boxes[..., 6:7]), np.sin(-boxes[..., 6:7])
    local = np.stack([shift[..., 0] * c - shift[..., 1] * s, shift[..., 0] * s + shift[..., 1] * c, shift[..., 2]], -1)
    near_face = (np.abs(np.abs(local) - boxes[:, :, None, 3:6] / 2) < 1e-3).any(-1).any(1)
    mask = (rnd.rand(S, N) > 0.05) & ~near_face
    pts = np.concatenate([xyz, rnd.uniform(0, 200, (S, N, 1))], -1).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in
            dict(pts=pts, mask=mask, boxes=boxes.astype(np.float32), box_mask=rnd.rand(S, K) > 0.1).items()}


def _on(device, scenes):
    return {k: v.to(device) for k, v in scenes.items()}


def _geom_close(got, want):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.is_floating_point():
        tol = GEOM_RTOL * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    else:
        assert torch.equal(got, want)


def test_projection_on_the_card_matches_the_cpu(scenes):
    from lidarcrafter_tpu_torch.ops import projection as X

    outs = {}
    for dev in ("cpu", "cuda"):
        d = _on(dev, scenes)
        gh, gw, depth = X.spherical_grid_coords(d["pts"][..., :3], 32, 1024)
        pixel = torch.where(d["mask"], gh.long() * 1024 + gw, 32 * 1024)
        outs[dev] = (pixel, *X.range_image_winners(pixel, depth, 32 * 1024),
                     X.points_to_range_image(d["pts"], d["mask"]),
                     *X.convert_boxes_to_2d(d["boxes"], d["box_mask"]))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _geom_close(got, want)
    assert int(outs["cpu"][2].sum()) > 0.5 * 32 * 1024 * ROLLOUT_S  # most pixels hit


def test_split_and_refine_on_the_card_match_the_cpu(scenes):
    from lidarcrafter_tpu_torch.datasets import rollout as R

    outs = {}
    for dev in ("cpu", "cuda"):
        d = _on(dev, scenes)
        member = R.points_in_boxes(d["pts"][..., :3], d["boxes"][..., :7]) & d["mask"][:, None]
        outs[dev] = (member, R.first_member_indices(member, 512),
                     *R.split_foreground_background(d["pts"], d["mask"], d["boxes"][..., :7], d["box_mask"], 512),
                     *R.refine_points_via_condition_mask(d["pts"], d["mask"], d["boxes"], d["box_mask"]))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _geom_close(got, want)
    assert int(outs["cpu"][4].sum()) > 0  # some objects hold points


def test_frame_step_on_the_card_matches_the_cpu_but_for_bin_edge_flips(scenes):
    """One frame's geometry step from a generated-like frame (points on the
    ray grid, not at pixel centres once warped): at least 99.9% of the
    condition pixels agree to 1e-5."""
    from lidarcrafter_tpu_torch.pipeline.temporal import frame_conditions, image_points_carry, scene_tracks
    from lidarcrafter_tpu_torch.sample_temporal import synthetic_scenes
    from lidarcrafter_tpu_torch.utils.lidar import LiDARUtility

    frame = torch.rand(ROLLOUT_S, 32, 1024, 2, generator=torch.Generator().manual_seed(1)) * 1.6 - 0.9
    outs = {}
    for dev in ("cpu", "cuda"):
        lu = LiDARUtility.create((32, 1024), "log_depth", 1.45, 80.0, device=dev)
        tracks = scene_tracks(*synthetic_scenes(ROLLOUT_S), 15, 16, torch.device(dev))
        carry = image_points_carry(frame.to(dev), lu)
        outs[dev] = frame_conditions(*carry, tracks.boxes[:, 3], tracks.next_boxes[:, 3], tracks.transforms[:, 3],
                                     tracks.classes_col, tracks.box_mask, lu)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        tol = GEOM_RTOL * max(1.0, float(want.abs().max()))
        flipped = int(((got.cpu() - want).abs() > tol).any(-1).sum())
        assert flipped <= 1e-3 * want[..., 0].numel(), flipped


def test_range_projection_is_deterministic_on_the_card(scenes):
    """Crowded pixels (several points each, depth ties among them): two
    calls give bit-identical images, since every scatter index is unique."""
    from lidarcrafter_tpu_torch.ops.projection import points_to_range_image

    d = _on("cuda", scenes)
    crowded = d["pts"].clone()
    crowded[:, 1::2, :3] = crowded[:, 0::2, :3]  # every odd point repeats its neighbour's xyz
    crowded[..., :3] *= 0.25  # and ~16 points share a pixel's ray
    a = points_to_range_image(crowded, d["mask"], H=8, W=256)
    b = points_to_range_image(crowded, d["mask"], H=8, W=256)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _geom_close(a, points_to_range_image(crowded.cpu(), d["mask"].cpu(), H=8, W=256))


# ------------------------------------------------------- training routes
#
# On the card each route is a ``torch.autograd.Function``: the forward
# launches the kernel, the backward recomputes the plain version in float32
# (``*_backward``).  Its gradients are held to autograd through the plain
# version on the same operands, to the forward rows' limits.


def _grad_case(route, dtype, gen):
    """(the route through the kernel, its plain version, the leaves) at a
    main-path shape (B=2), operands as the blocks pass them."""
    def leaf(t):
        return t.to(dtype).requires_grad_()

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if route.startswith("oaca"):
        H, L = (8, 2048) if route == "oaca ds4" else (16, 512)
        qkv = leaf(r(2, L, 3 * H * 32))
        heads = lambda t: t.reshape(2, L, H, -1).transpose(1, 2)  # noqa: E731
        ipe, k_l, v_l = leaf(r(2, L, H * 32)), leaf(r(2, H, 13, 64)), leaf(r(2, 13, H * 32))
        scale = 1 / math.sqrt(math.sqrt(64))

        def ops():
            q_c, k_c, v_c = (heads(t) for t in qkv.chunk(3, dim=-1))
            return q_c, heads(ipe), k_c, k_l, v_c, v_l.reshape(2, 13, H, 32).transpose(1, 2)

        return (lambda: oaca.oaca_attention(*ops(), scale=scale),
                lambda: oaca.oaca_attention_plain(*ops(), scale=scale), [qkv, ipe, k_l, v_l])
    if route == "attention wide d=256":  # OpenAIUNet's one head at ds 4, ragged
        qkv = leaf(r(2, 300, 3 * 256))

        def ops():
            return [t[:, None] for t in qkv.split(256, dim=-1)]

        return (lambda: attention.attention(*ops(), scale=256**-0.5),
                lambda: attention.attention_plain(*ops(), scale=256**-0.5), [qkv])
    if route.startswith("attention"):
        d = 64 if route == "attention d_block4" else 32
        qkv = leaf(r(2, 512, 3 * 8 * d))

        def ops():
            return [t.reshape(2, 512, 8, d).transpose(1, 2) for t in qkv.split(8 * d, dim=-1)]

        return (lambda: attention.attention(*ops(), scale=d**-0.5),
                lambda: attention.attention_plain(*ops(), scale=d**-0.5), [qkv])
    shape, groups, eps, affine, ss = {
        "groupnorm level0 scale-shift": ((2, 32, 1024, 64), 32, 1e-5, True, True),
        "groupnorm level0 192": ((2, 32, 1024, 192), 32, 1e-5, True, False),
        "groupnorm ds8": ((2, 4, 128, 1024), 32, 1e-5, True, False),
        "groupnorm tokens": ((2, 13, 64), 32, 1e-5, True, False),
        "groupnorm AdaGN": ((2, 32, 1024, 64), 8, 1e-6, False, True),
    }[route]
    C = shape[-1]
    x = leaf(r(*shape) * 2 + 1)
    w, b = (leaf(1 + 0.1 * r(C)), leaf(0.1 * r(C))) if affine else (None, None)
    proj = leaf(0.3 * r(2, 2 * C)) if ss else None
    leaves = [t for t in (x, w, b, proj) if t is not None]

    def args():
        s, t = proj.chunk(2, dim=-1) if ss else (None, None)
        return dict(num_groups=groups, eps=eps, scale=s, shift=t, silu=True)

    return (lambda: groupnorm.group_norm(x, w, b, **args()),
            lambda: groupnorm.group_norm_plain(x, w, b, **args()), leaves)


GRAD_ROUTES = ["oaca ds4", "oaca ds8", "attention d_block4", "attention u_block4", "groupnorm level0 scale-shift",
               "groupnorm level0 192", "groupnorm ds8", "groupnorm tokens", "groupnorm AdaGN", "attention wide d=256"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", GRAD_ROUTES)
def test_route_gradients_through_the_kernel_match_autograd_through_plain(gen, route, dtype):
    kernel, plain, leaves = _grad_case(route, dtype, gen)
    out = kernel()
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(plain(), leaves, g)
    for d, e in zip(got, want):
        assert d.dtype == e.dtype == dtype
        _assert_close(d, e, dtype)


@pytest.mark.parametrize("route", ["oaca ds8", "attention u_block4", "groupnorm level0 scale-shift"])
def test_routes_carry_a_grad_fn_and_serve_unchanged(gen, route):
    """With an operand that requires grad the result has the Function's
    ``grad_fn`` and the backward launches no kernel; under
    ``inference_mode`` the same call launches the kernel once, with no
    ``grad_fn``, and gives the same output bit for bit."""
    counter = {"oaca": oaca.launches, "attention": attention.launches, "groupnorm": groupnorm.launches}[
        route.split()[0]]
    kernel, _, leaves = _grad_case(route, torch.float32, gen)
    n = counter.n
    out = kernel()
    assert type(out.grad_fn).__name__ in ("OacaAttentionBackward", "AttentionBackward", "GroupNormBackward")
    assert counter.n == n + 1
    torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert counter.n == n + 1
    with torch.inference_mode():
        served = kernel()
    assert served.grad_fn is None and counter.n == n + 2
    assert torch.equal(served, out.detach())


def test_a_layout_train_forward_launches_what_serving_does():
    """``nuscenes-box-layout-v6`` at full width, B=1: a serving forward and a
    training forward + backward each launch 11 OACA and 101 GroupNorm
    kernels (the backward none), and every parameter gets a gradient."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training, layout_condition_batch
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("nuscenes-box-layout-v6")
    models, engine, _ = build_diffusion_training(cfg, "cuda")
    init_random_(models["cond"], 0)
    init_random_(models["model"], 1)
    batch = layout_condition_batch(cfg, 1, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    batch["x_0"] = torch.rand(1, 32, 1024, 2, device="cuda") * 2 - 1

    def counts(fn):
        for c in (oaca.launches, groupnorm.launches, attention.launches):
            c.n = 0
        out = fn()
        torch.cuda.synchronize()
        return out, (oaca.launches.n, groupnorm.launches.n, attention.launches.n)

    with torch.inference_mode():
        _, served = counts(lambda: engine.denoise(
            batch["x_0"], torch.zeros(1, device="cuda"), engine.get_network_condition(batch)))
    params = [p for m in models.values() for p in m.parameters()]
    _, trained = counts(lambda: torch.autograd.grad(
        engine.loss(batch, t=torch.full((1,), 0.5, device="cuda")), params))
    assert served == trained == (11, 101, 0)


# ------------------------------------------------------------------ layout branch


@pytest.mark.parametrize("C,eps,silu", [(512, 1e-5, True), (1024, 1e-5, True), (512, 1e-6, False)])
def test_groupnorm_kernel_at_the_layout_unets_token_shapes(gen, C, eps, silu):
    """``UNet1DModel``'s norms: 104 one-row images (8 scenes of 13 nodes),
    32 groups of 16 or 32 channels, float32, the module's own (C,) weight
    and bias."""
    x = (torch.randn(104, 1, C, generator=gen, device="cuda") * 3 + 5)
    w = 1 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    b = 0.1 * torch.randn(C, generator=gen, device="cuda")
    args = dict(num_groups=32, eps=eps, silu=silu)
    n = groupnorm.launches.n
    got = groupnorm.group_norm(x, w, b, **args)
    torch.cuda.synchronize()
    assert groupnorm.launches.n == n + 1
    _assert_close(got, groupnorm.group_norm_plain(x, w, b, **args), torch.float32)


def test_a_full_width_unet1d_call_launches_56_group_norms():
    """``nuscenes-layout`` at its published widths: one denoiser call on 8
    synthetic scenes of 13 nodes launches the GroupNorm kernel once per
    norm (22 residual blocks × 2, 11 transformers, the output norm) and no
    other kernel, and matches the same call on the CPU to 1e-3."""
    import copy
    import dataclasses

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator, layout_request
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_scene_graphs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = LayoutGenerator(get_config("nuscenes-layout"), "cuda")
    batch = synthetic_scene_graphs(8, 12, seed=0)
    x = torch.randn(104, 20, generator=torch.Generator().manual_seed(1))
    t = torch.linspace(-5, 5, 104)

    def call(engine, device):
        with torch.inference_mode():
            cond = engine.get_network_condition(layout_request(batch, device))
            return engine.denoise(x.to(device), t.to(device), cond)

    for c in (oaca.launches, groupnorm.launches, attention.launches):
        c.n = 0
    got = call(gen.engine, "cuda").cpu()
    torch.cuda.synchronize()
    assert (oaca.launches.n, groupnorm.launches.n, attention.launches.n) == (0, 56, 0)
    cpu = {k: copy.deepcopy(m).cpu() for k, m in gen.models.items()}
    want = call(dataclasses.replace(gen.engine, model=cpu["model"], cond_model=cpu["cond"]), "cpu")
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("C,eps,silu", [(512, 1e-5, True), (1024, 1e-5, True), (512, 1e-6, False)])
def test_groupnorm_kernel_at_the_layout_unets_token_shapes_in_bfloat16(gen, C, eps, silu):
    """The same norms as the layout branch trains them under bf16 AMP:
    every operand bfloat16."""
    x = (torch.randn(104, 1, C, generator=gen, device="cuda") * 3 + 5).bfloat16()
    w = (1 + 0.1 * torch.randn(C, generator=gen, device="cuda")).bfloat16()
    b = (0.1 * torch.randn(C, generator=gen, device="cuda")).bfloat16()
    args = dict(num_groups=32, eps=eps, silu=silu)
    n = groupnorm.launches.n
    got = groupnorm.group_norm(x, w, b, **args)
    torch.cuda.synchronize()
    assert groupnorm.launches.n == n + 1 and got.dtype == torch.bfloat16
    _assert_close(got, groupnorm.group_norm_plain(x, w, b, **args), torch.bfloat16)


# ------------------------------------------------------------------ forward mode (the MeanFlow loss)


def _jvp_case(route, dtype, gen):
    """(wrapper call, plain call, primals, tangents, counter, parameter) at
    the MeanFlow UNet's shapes: attention on per-head views of one qkv
    projection (u_block4: 512 tokens, 8 heads of 32), GroupNorm as the
    level-0 AdaGN (scale and shift halves of one projection, SiLU)."""
    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    if route == "attention":
        B, L, H, d = 2, 512, 8, 32
        p = torch.ones(H * d, device="cuda", requires_grad=True)

        def split(qkv):
            return [t.reshape(B, L, H, d).transpose(1, 2) for t in (qkv * p.to(dtype).repeat(3)).split(H * d, -1)]

        call = lambda qkv: attention.attention(*split(qkv), scale=d**-0.5)  # noqa: E731
        plain = lambda qkv: attention.attention_plain(*split(qkv), scale=d**-0.5)  # noqa: E731
        primals = (r(B, L, 3 * H * d),)
        return call, plain, primals, (r(B, L, 3 * H * d),), attention.launches, p
    B, C = 2, 64
    p = torch.ones(2 * C, device="cuda", requires_grad=True)

    def args(proj):
        s, t = (proj * p.to(dtype)).chunk(2, dim=-1)
        return dict(num_groups=8, eps=1e-6, scale=s, shift=t, silu=True)

    call = lambda x, proj: groupnorm.group_norm(x, None, None, **args(proj))  # noqa: E731
    plain = lambda x, proj: groupnorm.group_norm_plain(x, None, None, **args(proj))  # noqa: E731
    primals = (r(B, 32, 128, C, scale=2.0) + 1, r(B, 2 * C, scale=0.3))
    return call, plain, primals, (r(B, 32, 128, C), r(B, 2 * C)), groupnorm.launches, p


@pytest.mark.parametrize("mode", ["torch.func.jvp", "forward_ad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["attention", "groupnorm"])
def test_route_tangents_through_the_kernel_match_the_plain_version(gen, route, dtype, mode):
    """A tangent on the operands sends the call through the Function (one
    kernel launch), whose tangent and primal equal the plain version's; a
    loss on the primal back-propagates as through the plain version."""
    from torch.autograd import forward_ad

    call, plain, primals, tangents, counter, p = _jvp_case(route, dtype, gen)
    n = counter.n
    if mode == "torch.func.jvp":
        out, tan = torch.func.jvp(call, primals, tangents)
    else:
        with forward_ad.dual_level():
            out, tan = forward_ad.unpack_dual(call(*(forward_ad.make_dual(a, t) for a, t in zip(primals, tangents))))
    torch.cuda.synchronize()
    assert counter.n == n + 1 and tan is not None and tan.dtype == dtype
    want_out, want_tan = torch.func.jvp(plain, primals, tangents)
    _assert_close(out, want_out, dtype)
    _assert_close(tan, want_tan, dtype)
    g = torch.autograd.grad(out.float().square().sum(), p)[0]
    g_want = torch.autograd.grad(want_out.float().square().sum(), p)[0]
    _assert_close(g, g_want, dtype)


@pytest.mark.parametrize("mode", ["torch.func.jvp", "forward_ad"])
def test_oaca_raises_on_a_tangent(gen, mode):
    from torch.autograd import forward_ad

    ops = [torch.randn(1, 2, L, d, generator=gen, device="cuda")
           for L, d in ((64, 32), (64, 32), (64, 32), (13, 64), (64, 32), (13, 32))]
    n = oaca.launches.n
    with pytest.raises(NotImplementedError, match="forward-mode"):
        if mode == "torch.func.jvp":
            torch.func.jvp(lambda q: oaca.oaca_attention(q, *ops[1:], scale=0.35), (ops[0],), (ops[0],))
        else:
            with forward_ad.dual_level():
                oaca.oaca_attention(forward_ad.make_dual(ops[0], ops[0]), *ops[1:], scale=0.35)
    assert oaca.launches.n == n


# ------------------------------------------------------------ the metric suite
#
# Each metric and extractor on the card against the same function on the
# CPU, at ``chip_smoke.py`` phase 10's limits: chamfer, JSD, MMD and TCD 1e-4
# relative; feature matrices 1e-3 relative L2 (convolutions in float32,
# TF32 off); Fréchet distances 1e-3 in float64 on both sides; EMD 1e-3 (the
# auction may break a near-tie the other way); BEV grids exactly.  And a CUDA
# input never leaves the card on the heavy ops.

METRIC_RTOL, FEATURE_RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def clouds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    rnd = np.random.RandomState(3)

    def scan(n):
        r, az, el = rnd.uniform(2, 60, n), rnd.uniform(-np.pi, np.pi, n), rnd.uniform(-0.5, 0.17, n)
        return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1).astype(np.float32)

    return [scan(n) for n in (20000, 24000, 20000, 18000)]


@pytest.fixture
def float32_convolutions():
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = tf32


def _rel(got, want):
    return abs(got - want) / abs(want)


def _rel_l2(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_on_the_card_matches_the_cpu(clouds, dims, masked):
    from lidarcrafter_tpu_torch.ops.chamfer import chamfer_distance, chamfer_metric

    x, y = (torch.as_tensor(c[None, :, :dims]) for c in clouds[:2])
    masks = (x[..., 0] > -20, y[..., 1] < 25) if masked else (None, None)
    want = chamfer_distance(x, y, *masks)
    got = chamfer_distance(x.cuda(), y.cuda(), *(None if m is None else m.cuda() for m in masks))
    for g, w in zip(got[:2], want[:2]):
        assert float((g.cpu() - w).abs().max()) <= METRIC_RTOL * max(1.0, float(w.abs().max()))
    for g, w in zip(got[2:], want[2:]):
        assert float((g.cpu() == w).float().mean()) >= 0.999  # argmin: only near-ties may differ
    card = float(chamfer_metric(x.cuda(), y.cuda(), *(None if m is None else m.cuda() for m in masks)))
    assert _rel(card, float(chamfer_metric(x, y, *masks))) <= METRIC_RTOL


def test_emd_on_the_card_matches_the_cpu(clouds):
    from lidarcrafter_tpu_torch.ops.emd import emd_auction

    x, y = (torch.as_tensor(c[None, :2048] / 60.0) for c in clouds[:2])
    d_cpu, a_cpu = emd_auction(x, y)
    d_card, a_card = emd_auction(x.cuda(), y.cuda())
    assert _rel(float(d_card.sqrt().mean()), float(d_cpu.sqrt().mean())) <= FEATURE_RTOL
    assert float((a_card.cpu() == a_cpu).float().mean()) >= 0.99


def test_bev_grids_on_the_card_match_the_cpu_exactly(clouds):
    from lidarcrafter_tpu_torch.metrics.bev import bev_occupancy_grid
    from lidarcrafter_tpu_torch.ops.bev import point_cloud_to_histogram

    for c in clouds:
        c = torch.as_tensor(c)
        c[:500, :2] = torch.round(c[:500, :2] / 1.6) * 1.6  # on histogram bin edges
        assert torch.equal(point_cloud_to_histogram(c.cuda()).cpu(), point_cloud_to_histogram(c))
        for data_type in ("32", "64"):
            assert torch.equal(bev_occupancy_grid(c.cuda(), data_type=data_type).cpu(),
                               bev_occupancy_grid(c, data_type=data_type))


def test_frechet_and_squared_mmd_on_the_card_match_the_cpu():
    import numpy as np

    from lidarcrafter_tpu_torch.metrics.distribution import compute_frechet_distance, compute_squared_mmd

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rnd = np.random.RandomState(4)
    for n, dims in ((64, 4096), (500, 256)):
        f1 = rnd.randn(n, dims).astype(np.float32)
        f2 = (rnd.randn(n, dims) * 1.1 + 0.1).astype(np.float32)
        assert _rel(compute_frechet_distance(f1, f2, device="cuda"),
                    compute_frechet_distance(f1, f2, device="cpu")) <= FEATURE_RTOL
        assert _rel(compute_squared_mmd(f1, f2, device="cuda"), compute_squared_mmd(f1, f2, device="cpu")) <= 1e-3


def test_extractors_on_the_card_match_the_cpu(clouds, float32_convolutions):
    import copy

    from lidarcrafter_tpu_torch.metrics.engine import EvaluationEngine
    from lidarcrafter_tpu_torch.metrics.extractor.pointnet import PointNetFeatureExtractor
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import RangeNet
    from lidarcrafter_tpu_torch.metrics.pretrained import pointnet_features, rangenet_lidargen
    from lidarcrafter_tpu_torch.weights import init_random_

    rangenet = init_random_(RangeNet(num_classes=17, backbone=53), 0)
    pointnet = init_random_(PointNetFeatureExtractor(), 1)
    feats = {}
    for dev in ("cuda", "cpu"):
        engine = EvaluationEngine(rangenet_apply=rangenet_lidargen(copy.deepcopy(rangenet).to(dev)),
                                  pointnet_apply=pointnet_features(copy.deepcopy(pointnet).to(dev)), device=dev)
        feats[dev] = engine.extract_features(clouds[:2], dev)
    for k, shape in (("rangenet", (2, 4096)), ("pointnet", (2, 1808)), ("bev_hist", (2, 100, 100))):
        assert feats["cuda"][k].shape == shape
        assert _rel_l2(torch.as_tensor(feats["cuda"][k]), torch.as_tensor(feats["cpu"][k])) <= FEATURE_RTOL


def test_icp_on_the_card_recovers_a_rigid_motion(clouds):
    from lidarcrafter_tpu_torch.metrics.temporal import icp_point_to_point

    src = torch.as_tensor(clouds[0]).cuda()
    yaw = math.radians(3.0)
    R = torch.tensor([[math.cos(yaw), -math.sin(yaw), 0.0], [math.sin(yaw), math.cos(yaw), 0.0], [0, 0, 1.0]]).cuda()
    t = torch.tensor([1.0, 0.5, 0.0]).cuda()
    R_est, t_est = icp_point_to_point(src, src @ R.T + t)
    assert R_est.device.type == "cuda"
    assert float((t_est - t).abs().max()) <= 0.05 and float((R_est - R).abs().max()) <= 1e-2


def test_sequence_tcd_on_the_card_matches_the_cpu(clouds):
    from lidarcrafter_tpu_torch.metrics.temporal import sequence_tcd

    frames = [c[:3000] for c in clouds]
    card, cpu = sequence_tcd(frames, device="cuda"), sequence_tcd(frames, device="cpu")
    assert list(card) == [1, 2, 3, 4]
    for k in cpu:
        assert all(_rel(a, b) <= METRIC_RTOL for a, b in zip(card[k], cpu[k]))


def test_evaluate_on_the_card_matches_the_cpu(clouds):
    from lidarcrafter_tpu_torch.metrics import evaluate

    ref, gen = [c[:4000] for c in clouds[:2]], [c[-4000:] for c in clouds[2:]]
    kw = {"verbose": False}
    card = evaluate(ref, gen, ["cd", "emd", "jsd", "mmd"], device="cuda", **kw)
    cpu = evaluate(ref, gen, ["cd", "emd", "jsd", "mmd"], device="cpu", **kw)
    for k in cpu:
        assert _rel(card[k], cpu[k]) <= (FEATURE_RTOL if k == "emd" else METRIC_RTOL), k


def test_heavy_metric_ops_never_leave_the_card(clouds):
    """No op of chamfer, EMD, the BEV grids or the feature extractors
    touches a CPU tensor of more than one element or reads a value back to
    the host, given CUDA inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from lidarcrafter_tpu_torch.metrics.bev import bev_occupancy_grid
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import preprocess_range_input
    from lidarcrafter_tpu_torch.metrics.pretrained import random_pointnet, random_rangenet_lidargen
    from lidarcrafter_tpu_torch.ops.bev import point_cloud_to_histogram
    from lidarcrafter_tpu_torch.ops.chamfer import chamfer_distance
    from lidarcrafter_tpu_torch.ops.emd import emd_auction

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.host = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            tensors = [t for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor)]
            if name in ("item", "_local_scalar_dense", "nonzero", "is_nonzero", "equal") or any(
                    t.device.type == "cpu" and t.numel() > 1 for t in tensors):
                self.host.append(name)
            return out

    x, y = (torch.as_tensor(c[:3000]).cuda() for c in clouds[:2])
    rangenet, pointnet = random_rangenet_lidargen(0, device="cuda"), random_pointnet(0, device="cuda")
    img = preprocess_range_input(torch.rand(1, 5, 32, 1024, device="cuda"))
    rangenet(img)  # the feature positions are built once per shape, then kept on the card
    calls = {"chamfer": lambda: chamfer_distance(x[None], y[None]),
             "emd": lambda: emd_auction(x[None, :1024] / 60, y[None, :1024] / 60, iters=5),
             "bev": lambda: (point_cloud_to_histogram(x), bev_occupancy_grid(x)),
             "rangenet": lambda: rangenet(img), "pointnet": lambda: pointnet(x[None, :2048])}
    for name, call in calls.items():
        with Recorder() as rec:
            call()
        assert rec.host == [], f"{name}: {rec.host}"


# ------------------------------------------------------------------ image-config zoo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,L,L2", [(1, 1, 1, 1), (2, 3, 100, 13), (1, 2, 64, 64), (3, 1, 130, 0), (1, 2, 1000, 13), (2, 1, 77, 1)]
)
def test_oaca_kernel_at_head_dims_64_matches_plain(gen, dtype, B, H, L, L2):
    """The v0 stack's instantiation: (dc, dp, dv) = (64, 64, 64), 64-row
    query tiles."""
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    ops = (r(B, H, L, 64), r(B, H, L, 64), r(B, H, L, 64), r(B, H, L2, 128), r(B, H, L, 64), r(B, H, L2, 64))
    scale = 1 / math.sqrt(math.sqrt(128))
    n = oaca.launches.n
    got = oaca.oaca_attention(*ops, scale=scale)
    torch.cuda.synchronize()
    assert oaca.launches.n == n + 1
    want = oaca.oaca_attention_plain(*ops, scale=scale)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v0_attention_block_on_the_card_matches_the_cpu(gen, dtype, float32_convolutions):
    """A v0 ``ObjectAwareCrossAttention`` at ds4 width (512 channels, 8
    heads of 64): the kernel reads the per-head views of the fused qkv
    projection and the 512-wide positional strips."""
    from lidarcrafter_tpu_torch.models.layout_unet import ObjectAwareCrossAttention
    from lidarcrafter_tpu_torch.weights import init_random_

    block = init_random_(ObjectAwareCrossAttention(512, 8, 256, resolution=8), 0)
    B, Hh, Ww, L2 = 2, 8, 256, 13
    cond = {"image_patch_bbox_embedding_for_resolution8": torch.randn(B, Hh * Ww, 256, generator=gen, device="cuda"),
            "obj_bbox_embedding": torch.randn(B, L2, 256, generator=gen, device="cuda"),
            "obj_class_embedding": torch.randn(B, L2, 256, generator=gen, device="cuda"),
            "xf_out": torch.randn(B, L2, 256, generator=gen, device="cuda")}
    x = torch.randn(B, Hh, Ww, 512, generator=gen, device="cuda")
    with torch.inference_mode():
        want = block(x.cpu(), {k: v.cpu() for k, v in cond.items()})
        card = block.to("cuda", dtype)
        n = oaca.launches.n
        got = card(x.to(dtype), {k: v.to(dtype) for k, v in cond.items()})
        torch.cuda.synchronize()
    assert oaca.launches.n == n + 1
    tol = 1e-3 if dtype == torch.float32 else 5e-2
    assert float((got.float().cpu() - want).abs().max()) <= tol * float(want.abs().max())


def test_a_full_width_v0_call_launches_6_oaca_and_one_group_norm_a_norm(float32_convolutions):
    """``nuscenes-box-layout`` at full width, B=1: one denoiser call
    launches OACA at head dims 64 six times (ds4: 2 down, mid, 3 up) and
    the GroupNorm kernel once per ``GroupNorm32``; card (kernels) against
    CPU (plain versions) to 1e-3 of the largest output."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.models.ops import GroupNorm32
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training, layout_condition_batch
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config("nuscenes-box-layout")
    models, engine, _ = build_diffusion_training(cfg, "cpu")
    init_random_(models["cond"], 0)
    init_random_(models["model"], 1)
    batch = layout_condition_batch(cfg, 1, generator=torch.Generator().manual_seed(0))
    x, t = torch.randn(1, 32, 1024, 2, generator=torch.Generator().manual_seed(1)), torch.tensor([2.0])
    with torch.inference_mode():
        want = engine.denoise(x, t, engine.get_network_condition(batch))
        for m in models.values():
            m.to("cuda")
        for c in (oaca.launches, groupnorm.launches, attention.launches):
            c.n = 0
        got = engine.denoise(x.cuda(), t.cuda(), engine.get_network_condition(
            {k: v.cuda() for k, v in batch.items()}))
        torch.cuda.synchronize()
    norms = sum(isinstance(m, GroupNorm32) for m in models["model"].modules())
    assert (oaca.launches.n, groupnorm.launches.n, attention.launches.n) == (6, norms, 0)
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_an_hdit_call_launches_no_kernel_and_matches_the_cpu(float32_convolutions):
    """``nuscenes-hdit-uncond`` at 32x1024, 64 base channels: plain PyTorch
    on the card, no kernel of the port launched; card against CPU to 1e-3."""
    from lidarcrafter_tpu_torch.models.hdit import HDiT
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_(HDiT((32, 1024), 2, base_channels=64, depths=(1, 1, 1, 1)), 0)
    x, t = torch.randn(2, 32, 1024, 2, generator=torch.Generator().manual_seed(0)), torch.tensor([-3.0, 5.0])
    with torch.inference_mode():
        want = model(x, t)
        for c in (oaca.launches, groupnorm.launches, attention.launches):
            c.n = 0
        got = model.cuda()(x.cuda(), t.cuda())
        torch.cuda.synchronize()
    assert (oaca.launches.n, groupnorm.launches.n, attention.launches.n) == (0, 0, 0)
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())


# ------------------------------------------- released checkpoints and CLIP
#
# An upstream-format checkpoint written from seeded port modules, converted
# by ``convert_checkpoint`` and served through the generator's ``ckpt=`` on
# the card: the weights bit for bit, one denoiser call against the source
# modules on the CPU to 1e-3 with the main path's launches; the CLIP text
# tower at ViT-B/32 text width on the card against the CPU to 1e-4.


@pytest.mark.parametrize("name,per_call", [("nuscenes-box-layout-v6", (11, 101, 0)),
                                           ("nuscenes-unet-uncond", (0, 50, 2))])
def test_a_converted_checkpoint_served_on_the_card_matches_the_cpu(tmp_path, name, per_call, float32_convolutions):
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.convert_checkpoint import convert_checkpoint
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch
    from lidarcrafter_tpu_torch.utils.torch_ckpt import build_modules, to_upstream_checkpoint
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = get_config(name)
    source = build_modules(cfg, "cpu")
    for i, k in enumerate(sorted(source)):
        init_random_(source[k], 20 + i)
    ckpt = to_upstream_checkpoint(cfg, source)
    ckpt["weights"] = {k: v + 1.0 for k, v in ckpt["weights"].items()}
    torch.save(ckpt, tmp_path / "upstream.pth")
    convert_checkpoint(tmp_path / "upstream.pth", cfg, tmp_path / "port")
    cond = cfg.condition_model is not None
    gen = (CondFrameGenerator if cond else UncondFrameGenerator)(cfg, "cuda", ckpt=str(tmp_path / "port"))
    served = gen.models if cond else {"model": gen.model}
    for k, m in source.items():
        for n, v in m.state_dict().items():
            assert torch.equal(served[k].state_dict()[n].cpu(), v), f"{k}.{n}"
    x, t = torch.randn(1, *cfg.data.resolution, 2, generator=torch.Generator().manual_seed(1)), torch.tensor([2.0])
    batch = layout_condition_batch(cfg, 1, generator=torch.Generator().manual_seed(0)) if cond else None

    def call(mods, device):
        other = {"other_condition": mods["cond"]({k: v.to(device) for k, v in batch.items()})} if cond else {}
        args = ({"time_condition": t.to(device), **other},) if cond else (t.to(device),)
        return mods["model"](x.to(device), *args)

    with torch.inference_mode():
        want = call(source, "cpu")
        for c in (oaca.launches, groupnorm.launches, attention.launches):
            c.n = 0
        got = call(served, "cuda")
        torch.cuda.synchronize()
    assert (oaca.launches.n, groupnorm.launches.n, attention.launches.n) == per_call
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_clip_on_the_card_matches_the_cpu(tmp_path):
    import gzip

    from lidarcrafter_tpu_torch.datasets.scene_graph import CLASSES, RELATIONSHIPS
    from lidarcrafter_tpu_torch.models.clip_text import CLIPTextEncoder, load_clip_text_encoder
    from lidarcrafter_tpu_torch.utils.torch_ckpt import clip_text, export
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tower = init_random_(CLIPTextEncoder(), 0)  # ViT-B/32 text dimensions
    torch.save(export(clip_text, tower.state_dict()), tmp_path / "clip.pt")
    with gzip.open(tmp_path / "bpe.txt.gz", "wt") as f:
        f.write("\n".join(["#version: test", "c a", "ca r</w>", "t r", "u c", "tr uc", "truc k</w>"]))
    words = list(CLASSES) + list(RELATIONSHIPS) + ["car will stop", "truck1 left car2"]
    card = load_clip_text_encoder(tmp_path / "clip.pt", tmp_path / "bpe.txt.gz")[0](words)
    cpu = load_clip_text_encoder(tmp_path / "clip.pt", tmp_path / "bpe.txt.gz", device="cpu")[0](words)
    assert card.device.type == "cuda" and card.shape == (len(words), 512)
    assert float((card.cpu() - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


# ------------------------------------------- the sparse 3D stack
#
# The voxel table ops, MinkowskiNet / SPVCNN at upstream's eval widths and
# Voxel R-CNN on the reduced grid, on the card against the CPU: voxel
# coordinates and NMS keep sets exactly, features to 1e-4 (ops) and 1e-3
# (networks) of the largest output; plain PyTorch, so no kernel of the
# port launches.


def _scan(n, seed, spread=40.0):
    g = torch.Generator().manual_seed(seed)
    r = torch.rand(n, generator=g) * spread + 2.0
    az, el = (torch.rand(n, generator=g) * 2 - 1) * math.pi, torch.rand(n, generator=g) * 0.6 - 0.5
    return torch.stack([r * el.cos() * az.cos(), r * el.cos() * az.sin(), r * el.sin()], 1)


def _no_launch():
    for c in (oaca.launches, groupnorm.launches, attention.launches):
        c.n = 0
    return lambda: (oaca.launches.n, groupnorm.launches.n, attention.launches.n) == (0, 0, 0)


@pytest.mark.parametrize("voxel_size,max_voxels", [(0.05, 32768), (0.05, 4096), (0.3, 16384)])
def test_voxelize_on_the_card_matches_the_cpu_exactly(voxel_size, max_voxels):
    from lidarcrafter_tpu_torch.ops.sparse import voxelize

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts = _scan(32768, 0) + 0.5 * voxel_size
    mask = torch.arange(32768) < 30000
    want = voxelize(pts, voxel_size, mask, max_voxels)
    got = voxelize(pts.cuda(), voxel_size, mask.cuda(), max_voxels)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_sparse_ops_on_the_card_match_the_cpu():
    from lidarcrafter_tpu_torch.ops import sparse as S

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(1)
    pts, mask = _scan(20000, 2, 20.0), torch.arange(20000) < 19000
    feats = torch.randn(20000, 4, generator=g)
    k27, k8, k8u = (torch.randn(*s, generator=g) / 8 for s in ((27, 4, 16), (8, 16, 32), (8, 32, 16)))
    cpu = {}
    for dev in ("cpu", "cuda"):
        to = [x.to(dev) for x in (pts, feats, mask, k27, k8, k8u)]
        vf, vc, vm, pv, _ = S.voxelize_mean(to[0], to[1], 0.1, to[2], 16384)
        f = S.submanifold_conv3d(vf[:, :4], vc, vm, to[3])
        d, dc, dm = S.sparse_downsample2(f, vc, vm, to[4], 16384)
        u = S.sparse_upsample2(d, dc, dm, vc, vm, to[5])
        s, sc, sm = S.sparse_conv3d_strided(f, vc, vm, torch.cat([to[3]] * 4, 1)[:, :16, :16], max_voxels=16384,
                                            out_spatial=(800, 800, 800))
        z = S.voxel_to_point_trilinear(u, vc, vm, pv, to[2], level=0)
        p = S.point_to_voxel_mean(z, pv, to[2], dc, dm, level=1)
        out = {"vf": vf, "vc": vc, "vm": vm, "f": f, "d": d, "dc": dc, "u": u, "s": s, "sc": sc, "z": z, "p": p}
        if dev == "cpu":
            cpu = out
    for k, v in out.items():
        if v.dtype.is_floating_point:
            assert float((v.cpu() - cpu[k]).abs().max()) <= 1e-4 * max(1.0, float(cpu[k].abs().max())), k
        else:
            assert torch.equal(v.cpu(), cpu[k]), k


@pytest.mark.parametrize("name", ["minkowskinet", "spvcnn"])
def test_sparse_backbones_on_the_card_match_the_cpu(tmp_path, name):
    """Upstream's eval widths (``DEFAULT_LAYERS`` at cr 0.5, 4 input dims,
    17 classes) from a torchsparse ``model.ckpt``, 32,768 points: the
    level-0 coordinates exactly, the descriptor to 1e-3 of the largest."""
    from lidarcrafter_tpu_torch.metrics.extractor import sparse_unet as SU
    from lidarcrafter_tpu_torch.metrics.pretrained import load_sparse_backbone, load_sparse_descriptor
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_((SU.MinkowskiNet if name == "minkowskinet" else SU.SPVCNN)(), 3)
    (tmp_path / "nuscenes" / name).mkdir(parents=True)
    torch.save(SU.to_torchsparse_state_dict(model.state_dict()), tmp_path / "nuscenes" / name / "model.ckpt")
    pts = _scan(32768, 4)
    feats, mask = torch.cat([pts, -torch.ones(32768, 1)], 1), torch.ones(32768, dtype=torch.bool)
    on = {}
    check = _no_launch()
    for dev in ("cpu", "cuda"):
        describe = load_sparse_descriptor(tmp_path, name, max_points=32768, device=dev)
        on[dev] = describe(pts.to(dev), feats.to(dev), mask.to(dev)).cpu()
        if name == "minkowskinet":
            m = load_sparse_backbone(tmp_path / "nuscenes" / name, name, 32768, dev)
            with torch.inference_mode():
                on[dev + " coords"] = m(pts.to(dev) + 0.025, feats.to(dev), mask.to(dev))["coords"].cpu()
    assert on["cuda"].shape == (16 * 48,)
    assert float((on["cuda"] - on["cpu"]).abs().max()) <= 1e-3 * float(on["cpu"].abs().max())
    if name == "minkowskinet":
        assert torch.equal(on["cuda coords"], on["cpu coords"])
    assert check()


def test_voxel_rcnn_on_the_card_matches_the_cpu(tmp_path):
    """A pcdet file of seeded weights (nuScenes head groups) on the reduced
    grid: voxel coordinates exactly, the CenterHead maps to 1e-3 of the
    largest, and NMS keeps the same boxes on the card and on the CPU from
    the same boxes and scores."""
    from lidarcrafter_tpu_torch.metrics.models import voxel_rcnn as VR
    from lidarcrafter_tpu_torch.ops.iou3d import nms

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lidarcrafter_tpu_torch.utils.torch_ckpt import to_pcdet_state_dict

    params = VR.seeded_params(5, bev_filters=(32, 64), bev_up=(32, 32), shared=16, roi_fc=64)
    torch.save({"model_state": to_pcdet_state_dict(params)}, tmp_path / "vr.pth")
    kw = dict(point_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 1.0), voxel_size=(0.1, 0.1, 0.1), max_voxels=8192,
              topk_per_head=32)
    pts = torch.cat([_scan(4096, 6, 7.0), torch.rand(4096, 1, generator=torch.Generator().manual_seed(7))], 1)
    mask = torch.ones(4096, dtype=torch.bool)
    on = {}
    check = _no_launch()
    for dev in ("cpu", "cuda"):
        det = VR.load_voxel_rcnn_from_pcdet(tmp_path / "vr.pth", device=dev, **kw)
        with torch.inference_mode():
            heads, _, coords, vmask = det.dense_maps(pts.to(dev), mask.to(dev))
            on[dev] = (heads, coords.cpu(), vmask.cpu(), det.predict(pts.to(dev), mask.to(dev)))
    assert torch.equal(on["cuda"][1], on["cpu"][1]) and torch.equal(on["cuda"][2], on["cpu"][2])
    for hg, hc in zip(on["cuda"][0], on["cpu"][0]):
        for k in hc:
            assert float((hg[k].cpu() - hc[k]).abs().max()) <= 1e-3 * float(hc[k].abs().max()), k
    boxes, scores = on["cuda"][3][0], on["cuda"][3][1]
    order_g, keep_g = nms(boxes, scores, 0.2)
    order_c, keep_c = nms(boxes.cpu(), scores.cpu(), 0.2)
    assert torch.equal(order_g.cpu(), order_c) and torch.equal(keep_g.cpu(), keep_c)
    assert check()


# ------------------------------------------------------- object-level metrics


def _object_crops(n, points, seed):
    """Box-normalised crops without ties: points of a scaled normal."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, points, 3, generator=g) * torch.tensor([1.0, 0.5, 0.3])


def test_pointmlp_on_the_card_matches_the_cpu():
    """Full width (1,024 points, embed 64, 4 stages, k = 24), seeded: the
    FPS indices of every stage equal, the logits and features to 1e-4 of
    the largest, no kernel launched."""
    from lidarcrafter_tpu_torch.metrics.extractor.pointmlp import point_mlp
    from lidarcrafter_tpu_torch.ops.points import farthest_point_sampling
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_(point_mlp(4), 5).eval()
    x = _object_crops(8, 1024, 6)
    check = _no_launch()
    on = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            fps = [farthest_point_sampling(x.to(dev), 512)]
            on[dev] = (m(x.to(dev)).cpu(), m(x.to(dev), return_features=True).cpu(), fps[0].cpu())
    assert torch.equal(on["cuda"][2], on["cpu"][2])
    for i in (0, 1):
        assert float((on["cuda"][i] - on["cpu"][i]).abs().max()) <= 1e-4 * float(on["cpu"][i].abs().max())
    assert check()


def test_glenet_on_the_card_matches_the_cpu():
    """exp20 widths (latent 8), 512-point crops, the draws injected: the
    eval boxes to 1e-4 of the largest; one float64 train step's parameters
    and running statistics to 1e-4; one float32 step's running statistics
    to 1e-4 and its update to 1e-3 in relative L2, without the tensors whose
    float64 gradient of the loss's data term is 0 to rounding on the CPU
    (the biases in front of a train-mode BatchNorm).  Adam's first update
    is about lr · sign(g) for each weight, so rounding noise in a gradient
    at or near 0 moves a weight by up to 2 · lr."""
    from lidarcrafter_tpu_torch.metrics.models import glenet as GL
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = init_random_(GL.GLENet(**GL.EXP20_KWARGS), 7)
    g = torch.Generator().manual_seed(8)
    batch = {"points": _object_crops(16, 512, 9), "text_feat": torch.randn(16, 512, generator=g),
             "gt_boxes_input": torch.randn(16, 8, generator=g), "gt_boxes": torch.randn(16, 7, generator=g) * 0.5}
    eps = torch.randn(16, 8, generator=g)
    ref = copy.deepcopy(model).double()
    reg, lat, _ = ref({k: v.double() for k, v in batch.items()}, eps=eps.double(), train=True)
    grads = torch.autograd.grad(reg + 0.5 * lat, list(ref.parameters()))
    gmax = max(float(g.abs().max()) for g in grads)
    unreached = {k for (k, _), g in zip(ref.named_parameters(), grads) if float(g.abs().max()) <= 1e-10 * gmax}
    assert unreached and all(k.endswith("bias") for k in unreached)
    check = _no_launch()
    boxes, states = {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev).eval()
        with torch.inference_mode():
            boxes[dev] = m({k: v.to(dev) for k, v in batch.items()}, eps=eps.to(dev)).cpu()
        for dtype in (torch.float64, torch.float32):
            m = copy.deepcopy(model).to(dev, dtype)
            tx = GL.make_glenet_optimizer(total_steps=10)
            state = tx.init(list(m.parameters()))
            GL.make_glenet_train_step(m, tx)(state, {k: v.to(dev, dtype) for k, v in batch.items()}, 0.5,
                                              eps=eps.to(dev, dtype))
            states[dev, dtype] = {k: v.cpu() for k, v in m.state_dict().items()}
    assert float((boxes["cuda"] - boxes["cpu"]).abs().max()) <= 1e-4 * float(boxes["cpu"].abs().max())
    for k, v in states["cpu", torch.float64].items():
        assert float((states["cuda", torch.float64][k] - v).abs().max()) <= 1e-4 * max(1.0, float(v.abs().max())), k
    card, cpu, init = states["cuda", torch.float32], states["cpu", torch.float32], model.state_dict()
    for k in (k for k in cpu if "running" in k):
        assert float((card[k] - cpu[k]).abs().max()) <= 1e-4 * max(1.0, float(cpu[k].abs().max())), k
    kept = [k for k, _ in model.named_parameters() if k not in unreached]
    gap = sum(float((card[k] - cpu[k]).double().square().sum()) for k in kept)
    norm = sum(float((cpu[k] - init[k]).double().square().sum()) for k in kept)
    assert (gap / norm) ** 0.5 <= 1e-3
    assert check()


def test_object_trainers_step_on_the_card_like_the_cpu(float32_convolutions):
    """One PointMLP step (1,024 points, B = 8, dropout off; float64: in
    float32 ReLUs and max-pools that switch on values within rounding of a
    tie move one lr-0.1 step's update by about 3e-3 of its size, which
    ``chip_smoke.py`` phase 16 holds at B = 32) and
    one RangeNet-21 step (32 × 1,024, B = 2, trained statistics, float32)
    card vs CPU: every parameter and running statistic to 1e-4 of its
    largest."""
    from lidarcrafter_tpu_torch.metrics.extractor.pointmlp import point_mlp
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import RangeNet
    from lidarcrafter_tpu_torch.training import classifier as CL
    from lidarcrafter_tpu_torch.training import segmentation as SG
    from lidarcrafter_tpu_torch.weights import init_random_

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(10)
    mlp = init_random_(point_mlp(4, dropout=0.0), 11).double()
    mlp_batch = {"points": _object_crops(8, 1024, 12).double(), "labels": torch.randint(0, 4, (8,), generator=g)}
    rn = init_random_(RangeNet(num_classes=17, backbone=21), 13)
    rn_batch = {"image": torch.rand(2, 5, 32, 1024, generator=g), "labels": torch.randint(0, 17, (2, 32, 1024),
                                                                                          generator=g)}
    check = _no_launch()
    states = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(mlp).to(dev)
        tx = CL.make_classifier_optimizer(epochs=10)
        CL.make_classifier_train_step(m, tx)(tx.init(list(m.parameters())), {k: v.to(dev) for k, v in
                                                                              mlp_batch.items()})
        r = copy.deepcopy(rn).to(dev)
        SG.train_frozen_statistics_(r)
        rtx = SG.make_rangenet_optimizer(warmup_steps=1)
        rstate = rtx.init(SG.trained_tensors(r))
        step = SG.make_segmentation_train_step(r, rtx, SG.rangenet_class_weights(17).to(dev), ignore_index=0)
        for _ in range(2):  # the LR is 0 at the first update
            step(rstate, {k: v.to(dev) for k, v in rn_batch.items()})
        states[dev] = {**{f"mlp.{k}": v.detach().cpu() for k, v in m.state_dict().items()},
                       **{f"rn.{k}": v.detach().cpu() for k, v in r.state_dict().items()}}
    for k, v in states["cpu"].items():
        assert float((states["cuda"][k] - v).abs().max()) <= 1e-4 * max(1.0, float(v.abs().max())), k
    assert check()


# --------------------------------------------------- operators and artifacts


def _op_args(dtype, gen):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    s, t = r(2, 128).chunk(2, dim=-1)
    return {
        "oaca": (torch.ops.lidarcrafter_torch.oaca_forward.default,
                 (r(2, 8, 2048, 32), r(2, 8, 2048, 32), r(2, 8, 2048, 32), r(2, 8, 13, 64), r(2, 8, 2048, 32),
                  r(2, 8, 13, 32), 0.35), oaca),
        "attention": (torch.ops.lidarcrafter_torch.attention_forward.default,
                      (r(2, 8, 512, 64), r(2, 8, 512, 64), r(2, 8, 512, 64), 0.125, 500), attention),
        "group_norm": (torch.ops.lidarcrafter_torch.group_norm.default,
                       (r(2, 32 * 64, 64), r(64).float(), r(64).float(), s, t, 32, 1e-5, True), groupnorm),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["oaca", "attention", "group_norm"])
def test_operator_on_the_card_launches_the_kernel(gen, dtype, name):
    """The ``torch.library`` operator on CUDA tensors: one launch, the
    plain version's values (chip limits), the fake rule's shape, dtype and
    strides; ``torch.library.opcheck`` on the card."""
    op, args, mod = _op_args(dtype, gen)[name]
    n = mod.launches.n
    got = op(*args)
    torch.cuda.synchronize()
    assert mod.launches.n == n + 1
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    want = op(*cpu_args)  # the CPU implementation: the plain version
    assert got.shape == want.shape and got.dtype == want.dtype and got.stride() == want.stride()
    _assert_close(got.cpu(), want, dtype)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("traced_on", ["cuda", "cpu"])
def test_artifact_replays_on_the_card(tmp_path, traced_on):
    """An uncond DDIM@2 artifact at reduced width (32x128, 16 channels,
    B = 2), traced on the card or on the CPU, replayed on the card: 2
    attention + 50 GroupNorm launches a denoiser call, frames equal to the
    eager card generator's for the same seed (1e-5 of the largest)."""
    from lidarcrafter_tpu_torch.configs import apply_reduced_topology, get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.serving import export_sampler, load_artifact, save_artifact

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = apply_reduced_topology(get_config("nuscenes-unet-uncond"), resolution=(32, 128), model_channels=16)
    gen = UncondFrameGenerator(cfg, traced_on)
    exported = export_sampler(gen.engine, gen.lidar_utils, batch_size=2, num_steps=2, mode="ddim")
    art = save_artifact(tmp_path / "art", exported, {"batch_size": 2, "num_steps": 2, "mode": "ddim",
                                                     "sampling_shape": list(gen.engine.sampling_shape),
                                                     "conditional": False})
    fn, meta = load_artifact(art, device="cuda")
    assert meta["device"].startswith(traced_on)
    n = (attention.launches.n, groupnorm.launches.n)
    got = fn(5)
    torch.cuda.synchronize()
    assert (attention.launches.n - n[0], groupnorm.launches.n - n[1]) == (2 * 2, 2 * 50)
    want = UncondFrameGenerator(cfg, "cuda").generate(2, 2, mode="ddim", seed=5)[1]
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * float(want[k].abs().max()), k
