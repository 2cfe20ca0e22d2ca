"""The port's attention kernel module on the CPU: its plain version against
the JAX package's Pallas attention kernel and its users, on the same inputs.

The JAX side runs as its own tests run it: ``attention_bhld``,
``flash_attention`` and ``fused_attention_fn`` with the Pallas kernel in
interpret mode.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` and ``test_torch_port_cuda.py`` hold it against this
plain version there).

Tolerance: float32, values O(1), each output a softmax-weighted sum over at
most 512 keys; the two frameworks scale the logits at another place (the
TPU route scales q and k by d^-¼ each, the port the f32 logits by d^-½) and
sum in another order, so 1e-5 absolute covers the difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarcrafter_tpu.models.ops import fused_attention_fn
from lidarcrafter_tpu.ops.pallas_attention import attention_bhld, flash_attention
from lidarcrafter_tpu_torch.kernels import attention as tattn

ATOL = 1e-5


def _arrays(*shapes, seed=0):
    rnd = np.random.RandomState(seed)
    return [rnd.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize(
    "B,h,Lq,Lkv,dqk,dv",
    [
        (2, 8, 64, 64, 16, 16),     # EfficientUNet d_block4 at reduced size
        (1, 4, 256, 141, 32, 32),   # KV padded to 256 and masked by the JAX wrapper
        (2, 1, 512, 512, 64, 64),   # the production head dim and token count
        (2, 2, 128, 77, 64, 32),    # dqk != dv
    ],
)
def test_attention_plain_matches_pallas_attention_bhld(B, h, Lq, Lkv, dqk, dv):
    q, k, v = _arrays((B, h, Lq, dqk), (B, h, Lkv, dqk), (B, h, Lkv, dv))
    scale = 1.0 / np.sqrt(dqk)
    c = float(np.sqrt(scale))  # the TPU route pre-scales q and k by d^-¼ each
    want = np.asarray(attention_bhld(
        jnp.asarray(q) * c, jnp.asarray(k) * c, jnp.asarray(v), block_q=min(128, Lq), interpret=True
    ))
    got = tattn.attention_plain(*_t(q, k, v), scale=scale).numpy()
    assert got.shape == want.shape == (B, h, Lq, dv)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_masks_the_padded_tail_like_flash_attention():
    """Keys past ``kv_len`` get no weight: the padded value rows are
    poisoned with 1e6 and must not leak into the output."""
    BH, Lq, Lkv, d, pad = 2, 256, 200, 32, 56
    q, k, v = _arrays((BH, Lq, d), (BH, Lkv, d), (BH, Lkv, d), seed=1)
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0)), constant_values=1e6)
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), kv_len=Lkv, block_q=128, interpret=True
    ))
    got = tattn.attention(*_t(q[None], kp[None], vp[None]), scale=1.0, kv_len=Lkv)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    unpadded = tattn.attention(*_t(q[None], k[None], v[None]), scale=1.0)[0].numpy()
    np.testing.assert_allclose(got, unpadded, rtol=0, atol=1e-6)


def test_attention_matches_fused_attention_fn_in_the_flax_layout():
    """``SelfAttention2d``'s route: flax (B, L, heads, d) operands; the port
    reads them as (B, heads, L, d) views and scales the logits by d^-½."""
    B, L, h, d = 2, 512, 8, 64
    q, k, v = _arrays((B, L, h, d), (B, L, h, d), (B, L, h, d), seed=2)
    want = np.asarray(fused_attention_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    tq, tk, tv = (t.transpose(1, 2) for t in _t(q, k, v))
    got = tattn.attention(tq, tk, tv, scale=1.0 / np.sqrt(d)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kv_len", [None, 1, 77])
def test_attention_plain_matches_float64_einsum(kv_len):
    B, h, Lq, Lkv, d = 2, 3, 40, 128, 24
    q, k, v = _arrays((B, h, Lq, d), (B, h, Lkv, d), (B, h, Lkv, d), seed=3)
    n = Lkv if kv_len is None else kv_len
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k[:, :, :n].astype(np.float64)) * 0.3
    w = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v[:, :, :n])
    got = tattn.attention_plain(*_t(q, k, v), scale=0.3, kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_takes_strided_head_views_and_the_cpu_takes_the_plain_version():
    """The blocks hand per-head views of one (B, L, 3C) projection; the
    wrapper reads them through their strides, and on the CPU it runs the
    plain version without counting a kernel launch."""
    B, L, C, nh = 2, 64, 64, 4
    (qkv,) = _t(*_arrays((B, L, 3 * C), seed=4))
    heads = [t.reshape(B, L, nh, C // nh).transpose(1, 2) for t in qkv.split(C, -1)]
    assert not heads[0].is_contiguous()
    launches = tattn.launches.n
    got = tattn.attention(*heads, scale=0.25)
    assert tattn.launches.n == launches
    torch.testing.assert_close(got, tattn.attention_plain(*heads, scale=0.25), rtol=0, atol=0)
    want = tattn.attention(*(t.contiguous() for t in heads), scale=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == torch.float32


def test_attention_keeps_the_operand_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_arrays((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16))))
    out = tattn.attention(q, k, v, scale=0.25)
    assert out.dtype == torch.bfloat16
    want = tattn.attention_plain(q.float(), k.float(), v.float(), scale=0.25)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)


def test_attention_refuses_what_it_does_not_take():
    q, k, v = _t(*_arrays((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="kv_len"):
            tattn.attention(q, k, v, scale=1.0, kv_len=bad)
    with pytest.raises(ValueError, match="shapes"):
        tattn.attention(q, k[:, :1], v, scale=1.0)
    meta = [torch.zeros(1, 2, 8, 16, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        tattn.attention(*meta, scale=1.0)
