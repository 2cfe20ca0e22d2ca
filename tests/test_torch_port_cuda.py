"""The port's CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach (ragged query tiles that are no multiple
of 16 or 64, layout strips of 0, 1, 13 and 64 tokens, odd channel counts,
tiny groups, masked key tails inside the first 16 keys, head dims 8-128 with
dqk != dv, logits near +-30), and the wrappers refusing what the kernels do
not take.  Marked ``cuda``; without a card they skip.  Run them on the card
with ``python -m pytest tests/test_torch_port_cuda.py``.

Tolerances as in ``chip_smoke.py``: float32 to 1e-4 and bfloat16 to 2e-2 of
max(1, max |plain|), and the error's norm to 1e-3 (float32) and 1e-2
(bfloat16) of the plain output's norm, which catches a fault on a few
percent of the keys where most outputs are far below 1.
"""

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


def test_oaca_kernel_refuses_head_dims_it_was_not_built_for(gen):
    ops = [torch.zeros(1, 1, 8, 16, device="cuda") for _ in range(3)]
    with pytest.raises(ValueError, match="head dims"):
        oaca.oaca_attention(ops[0], ops[1], ops[2], torch.zeros(1, 1, 2, 32, device="cuda"),
                            ops[0], torch.zeros(1, 1, 2, 16, device="cuda"), scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,per_batch,silu",
    [((2, 13, 64), False, False), ((1, 1, 32), False, True), ((3, 7, 9, 96), True, True),
     ((2, 5, 1024), True, False), ((2, 4000, 192), False, True)],
)
def test_groupnorm_kernel_matches_plain(gen, dtype, shape, per_batch, silu):
    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 5).to(dtype)
    rows = B if per_batch else 1
    gamma = 1 + 0.1 * torch.randn(rows, C, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(rows, C, generator=gen, device="cuda")
    args = dict(num_groups=32, eps=1e-5, silu=silu)
    n = groupnorm.launches.n
    got = groupnorm.group_norm(x, gamma, beta, **args)
    torch.cuda.synchronize()
    assert groupnorm.launches.n == n + 1
    want = groupnorm.group_norm_plain(x, gamma.expand(B, C), beta.expand(B, C), **args)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype)


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
    q = torch.zeros(1, 1, 8, 129, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        attention.attention(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="head dims"):
        attention.attention(q[..., :64], q[..., :64], q, scale=1.0)
