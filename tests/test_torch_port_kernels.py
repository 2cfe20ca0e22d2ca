"""The port's kernel modules on the CPU: their plain versions against the
JAX package's kernels and modules, on the same inputs.

The JAX side runs as its own tests run it: the Pallas kernels in interpret
mode, their XLA references (``_oaca_unfused``, ``_gn_ref``) and the
``GroupNorm32`` module.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions there).

Tolerances: float32 everywhere; values are O(1) and each output is a short
sum (≤ 2061-key softmax, ≤ 65536-element mean), so 1e-5 absolute covers the
different summation orders.  The Pallas GroupNorm takes one-pass
``E[x²] − mean²`` statistics, which on zero-mean data agree to 1e-5 too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarcrafter_tpu.models.ops import GroupNorm32 as JaxGroupNorm32
from lidarcrafter_tpu.ops.pallas_attention import _oaca_unfused, oaca_attention as jax_oaca
from lidarcrafter_tpu.ops.pallas_groupnorm import _gn_ref, fused_group_norm
from lidarcrafter_tpu_torch.kernels import groupnorm, loader, oaca
from lidarcrafter_tpu_torch.models.ops import GroupNorm32

ATOL = 1e-5


def _oaca_inputs(B, h, Lq, L2, d, seed=0):
    rnd = np.random.RandomState(seed)
    shapes = [(B, h, Lq, d), (B, h, Lq, d), (B, h, Lq, d), (B, h, L2, 2 * d),
              (B, h, Lq, d), (B, h, L2, d)]
    return [rnd.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("B,h,Lq,L2", [(2, 2, 64, 13), (1, 4, 256, 13), (2, 1, 128, 1)])
def test_oaca_plain_matches_jax(B, h, Lq, L2):
    arrs = _oaca_inputs(B, h, Lq, L2, 32)
    scale = float(1 / np.sqrt(np.sqrt(64)))
    want_ref = np.asarray(_oaca_unfused(*map(jnp.asarray, arrs), scale))
    want_kernel = np.asarray(jax_oaca(
        *map(jnp.asarray, arrs), scale=scale, block_q=min(128, Lq), interpret=True
    ))
    tin = [torch.as_tensor(a) for a in arrs]
    got_plain = oaca.oaca_attention_plain(*tin, scale=scale).numpy()
    launches = oaca.launches.n
    got_wrapper = oaca.oaca_attention(*tin, scale=scale).numpy()
    assert oaca.launches.n == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got_plain, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_plain, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_wrapper, got_plain)


def test_oaca_plain_takes_strided_head_views():
    """The block hands per-head views of a fused projection; the plain
    version (like the kernel) must read them through their strides."""
    B, L, C, nh = 2, 64, 64, 2
    rnd = np.random.RandomState(1)
    qkv = torch.as_tensor(rnd.standard_normal((B, L, 3 * C)).astype(np.float32))
    heads = [t.reshape(B, L, nh, C // nh).transpose(1, 2) for t in qkv.chunk(3, -1)]
    ipe = torch.as_tensor(rnd.standard_normal((B, nh, L, 32)).astype(np.float32))
    k_l = torch.as_tensor(rnd.standard_normal((B, nh, 13, 64)).astype(np.float32))
    v_l = torch.as_tensor(rnd.standard_normal((B, nh, 13, 32)).astype(np.float32))
    q_c, k_c, v_c = heads
    got = oaca.oaca_attention(q_c, ipe, k_c, k_l, v_c, v_l, scale=0.3)
    want = oaca.oaca_attention(
        q_c.contiguous(), ipe, k_c.contiguous(), k_l, v_c.contiguous(), v_l, scale=0.3
    )
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _jax_gn32(x, scale, bias, scale_shift, silu):
    m = JaxGroupNorm32(num_groups=32, epsilon=1e-5)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ss = None if scale_shift is None else tuple(jnp.asarray(a) for a in scale_shift)
    return np.asarray(m.apply(params, jnp.asarray(x), scale_shift=ss, silu=silu))


@pytest.mark.parametrize(
    "shape,scale_shift,silu",
    [
        ((2, 8, 32, 64), True, True),   # ResBlock out_norm: scale-shift + SiLU
        ((2, 8, 32, 96), False, True),  # in_norm on a decoder concat
        ((2, 13, 64), False, False),    # token norm: 2-channel x 13-token groups
        ((3, 13, 256), False, False),   # 8-channel x 13-token groups
        ((2, 64, 128), False, False),
    ],
)
def test_groupnorm_plain_matches_jax_groupnorm32(shape, scale_shift, silu):
    rnd = np.random.RandomState(0)
    C = shape[-1]
    # a non-zero mean: the case where one-pass E[x²] − mean² statistics cancel
    x = (rnd.standard_normal(shape) * 2.0 + 3.0).astype(np.float32)
    w = (1 + 0.1 * rnd.standard_normal(C)).astype(np.float32)
    b = (0.1 * rnd.standard_normal(C)).astype(np.float32)
    ss = None
    if scale_shift:
        ss = tuple(
            (0.3 * rnd.standard_normal((shape[0], 1, 1, C))).astype(np.float32) for _ in range(2)
        )
    want = _jax_gn32(x, w, b, ss, silu)

    mod = GroupNorm32(C)
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(w))
        mod.bias.copy_(torch.as_tensor(b))
        tss = None if ss is None else tuple(torch.as_tensor(a) for a in ss)
        launches = groupnorm.launches.n
        got = mod(torch.as_tensor(x), scale_shift=tss, silu=silu).numpy()
    assert groupnorm.launches.n == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_plain_matches_pallas_kernel(silu):
    rnd = np.random.RandomState(2)
    B, HW, C, G = 2, 512, 128, 32
    x = rnd.standard_normal((B, HW, C)).astype(np.float32)
    gamma = (1 + 0.1 * rnd.standard_normal((B, C))).astype(np.float32)
    beta = (0.1 * rnd.standard_normal((B, C))).astype(np.float32)
    args = dict(num_groups=G, eps=1e-5, silu=silu)
    want_kernel = np.asarray(fused_group_norm(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), interpret=True, **args
    ))
    want_ref = np.asarray(_gn_ref(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), **args))
    got = groupnorm.group_norm(
        torch.as_tensor(x), torch.as_tensor(gamma), torch.as_tensor(beta), **args
    ).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)


def test_groupnorm_rejects_channels_that_do_not_split():
    x = torch.zeros(2, 4, 30)
    with pytest.raises(ValueError):
        groupnorm.group_norm(x, torch.ones(30), torch.zeros(30), num_groups=32, eps=1e-5)


def test_wrappers_refuse_devices_they_were_not_built_for():
    x = torch.zeros(2, 4, 64, device="meta")
    with pytest.raises(ValueError):
        groupnorm.group_norm(x, torch.ones(64, device="meta"), torch.zeros(64, device="meta"),
                             num_groups=32, eps=1e-5)
    ops = [torch.zeros(1, 1, 64, 32, device="meta") for _ in range(3)]
    k_l = torch.zeros(1, 1, 13, 64, device="meta")
    v_l = torch.zeros(1, 1, 13, 32, device="meta")
    with pytest.raises(ValueError):
        oaca.oaca_attention(ops[0], ops[1], ops[2], k_l, ops[0], v_l, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignment_check_refuses_operands_that_cp_async_cannot_copy(dtype):
    """The attention kernels copy rows in 16-byte pieces: a view one element
    in (pointer and row stride off 16 bytes) or a head dim that is no whole
    piece is refused before any launch; per-head views of a fused projection
    and stride-0 broadcasts pass."""
    wide = torch.zeros(1, 2, 64, 65, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte"):
        loader.check_aligned("attention", wide[..., 1:])
    with pytest.raises(ValueError, match="16-byte"):
        loader.check_aligned("attention", torch.zeros(1, 2, 64, 4, dtype=dtype)[..., :2])
    qkv = torch.zeros(2, 100, 3 * 256, dtype=dtype)
    heads = [t.reshape(2, 100, 8, 32).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    loader.check_aligned("attention", *heads, torch.zeros(1, 100, 32, dtype=dtype).expand(2, 8, 100, 32))
