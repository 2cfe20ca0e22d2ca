"""The backward of the port's three kernel routes against the JAX package's
custom VJPs, on the CPU.

On the card ``oaca_attention``, ``attention`` and ``group_norm`` are
``torch.autograd.Function``s whose backward is a plain function:
``oaca_attention_backward`` and ``group_norm_backward`` (autograd of the
plain version recomputed in float32) and ``attention_backward`` (the
hand-derived float32 einsums).  Here each of those functions is held to
``jax.vjp`` of the JAX wrapper run as the JAX package's tests run it
(``oaca_attention``, ``flash_attention``, ``fused_group_norm`` with
``interpret=True``), on the same numpy-seeded operands and output gradient,
in float32 and bfloat16: ragged layout strips, a masked key tail, dqk ≠ dv,
GroupNorm with and without affine, scale-shift and SiLU.  The output
gradient has the strides of the kernels' output ((B, L, heads, d) memory).
Limits: 1e-5 (float32) and 2e-2 (bfloat16) of the largest JAX gradient
entry, per operand.

Then the Functions themselves, with the kernel launch replaced by the plain
version (the CUDA kernel runs only on the card): their gradients equal
autograd through the plain version, and every route returns a tensor with
a ``grad_fn`` for an operand that requires grad.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidarcrafter_tpu.ops.pallas_attention import flash_attention as j_flash
from lidarcrafter_tpu.ops.pallas_attention import oaca_attention as j_oaca
from lidarcrafter_tpu.ops.pallas_groupnorm import fused_group_norm as j_gn
from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(rnd, *shape, scale=1.0):
    return (scale * rnd.standard_normal(shape)).astype(np.float32)


def _strided_g(rnd, B, H, L, d):
    """An output gradient (B, H, L, d) laid out (B, L, H, d), as the
    kernels' output is."""
    return torch.as_tensor(_draw(rnd, B, L, H, d)).transpose(1, 2)


def _pair(arrays, dname):
    tdt, jdt = DTYPES[dname]
    return [torch.as_tensor(a).to(tdt) for a in arrays], [jnp.asarray(a, jdt) for a in arrays]


def _assert_grads(got, want, dname):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        err = np.abs(g - w).max()
        assert err <= TOL[dname] * np.abs(w).max(), (i, err, np.abs(w).max())


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,L,L2", [(1, 2, 24, 13)])
def test_oaca_backward_matches_jax_vjp(dname, B, H, L, L2):
    rnd = np.random.RandomState(L + L2)
    shapes = [(B, H, L, 32)] * 3 + [(B, H, L2, 64), (B, H, L, 32), (B, H, L2, 32)]
    t_ops, j_ops = _pair([_draw(rnd, *s) for s in shapes], dname)
    g = _strided_g(rnd, B, H, L, 32).to(t_ops[0].dtype)
    scale = 1.0 / math.sqrt(math.sqrt(64))
    got = oaca.oaca_attention_backward(t_ops, g, scale=scale)
    assert all(d.dtype == t.dtype for d, t in zip(got, t_ops))
    _, vjp = jax.vjp(lambda *a: j_oaca(*a, scale=scale, interpret=True), *j_ops)
    _assert_grads(got, vjp(jnp.asarray(g.float().numpy(), j_ops[0].dtype)), dname)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Lq,Lkv,dqk,dv,kv_len", [(2, 2, 24, 24, 16, 16, None), (1, 2, 20, 32, 16, 8, 17)])
def test_attention_backward_matches_jax_vjp(dname, B, H, Lq, Lkv, dqk, dv, kv_len):
    """JAX's ``flash_attention`` takes q pre-scaled; the port's ``attention``
    takes the scale, so dq (and dk) carry it."""
    rnd = np.random.RandomState(Lq + Lkv)
    (q, k, v), (jq, jk, jv) = _pair(
        [_draw(rnd, B, H, Lq, dqk), _draw(rnd, B, H, Lkv, dqk), _draw(rnd, B, H, Lkv, dv)], dname
    )
    g = _strided_g(rnd, B, H, Lq, dv).to(q.dtype)
    scale = 1.0 / math.sqrt(dqk)
    got = attention.attention_backward(q, k, v, g, scale=scale, kv_len=kv_len)

    def f(q, k, v):
        flat = lambda t: t.reshape(B * H, *t.shape[2:])  # noqa: E731
        out = j_flash(flat(q * scale), flat(k), flat(v), kv_len=kv_len, block_q=Lq, interpret=True)
        return out.reshape(B, H, Lq, dv)

    _, vjp = jax.vjp(f, jq, jk, jv)
    _assert_grads(got, vjp(jnp.asarray(g.float().numpy(), jq.dtype)), dname)


GN_CASES = {  # (weight and bias, scale-shift, SiLU)
    "affine": (True, False, False),
    "affine+SiLU": (True, False, True),
    "affine+scale-shift+SiLU": (True, True, True),
    "scale-shift+SiLU (AdaGN)": (False, True, True),
}


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GN_CASES))
def test_group_norm_backward_matches_jax_vjp(dname, case):
    """The port's gradients reach weight, bias and the strided scale /
    shift halves of one (B, 2C) projection; JAX's ``fused_group_norm``
    takes the folded γ = w(1+s), β = b(1+s) + t, folded here in float32."""
    affine, ss, silu = GN_CASES[case]
    B, H, W, C, G, eps = 2, 4, 8, 32, 8, 1e-6
    rnd = np.random.RandomState(len(case))
    arrays = [_draw(rnd, B, H, W, C, scale=2.0) + 1.0, 1.0 + _draw(rnd, C, scale=0.1), _draw(rnd, C, scale=0.1),
              _draw(rnd, B, 2 * C, scale=0.3)]
    (x, w, b, proj), (jx, jw, jb, jproj) = _pair(arrays, dname)
    s, t = proj.chunk(2, dim=-1)
    saved = (x, w if affine else None, b if affine else None, s if ss else None, t if ss else None)
    g = torch.as_tensor(_draw(rnd, B, H, W, C)).to(x.dtype)
    got = groupnorm.group_norm_backward(saved, g, num_groups=G, eps=eps, silu=silu)
    assert [d is None for d in got] == [o is None for o in saved]

    def f(x, w, b, proj):
        f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
        gamma, beta = (f32(w), f32(b)) if affine else (jnp.ones((C,)), jnp.zeros((C,)))
        if ss:
            s1 = 1.0 + f32(proj[:, :C])
            gamma, beta = gamma * s1, beta * s1 + f32(proj[:, C:])
        return j_gn(x, gamma, beta, num_groups=G, eps=eps, silu=silu, interpret=True)

    _, vjp = jax.vjp(f, jx, jw, jb, jproj)
    dx, dw, db, dproj = vjp(jnp.asarray(g.float().numpy(), jx.dtype))
    pairs = [(got[0], dx)]
    if affine:
        pairs += [(got[1], dw), (got[2], db)]
    if ss:
        pairs += [(got[3], dproj[:, :C]), (got[4], dproj[:, C:])]
    _assert_grads([p[0] for p in pairs], [p[1] for p in pairs], dname)


# ------------------------------------------------- the Functions on the CPU


def _plain_launches(monkeypatch):
    """Each route's kernel launch replaced by its plain version, after
    reading every operand's pointer as the launch does (a tensor wrapped by
    a ``torch.func`` transform has none); the attention outputs in the
    kernels' (B, L, heads, d) memory layout."""

    def read(*ops):
        for t in ops:
            if t is not None:
                t.data_ptr()

    def kernel_layout(out):
        return out.transpose(1, 2).contiguous().transpose(1, 2)

    def oaca_launch(*ops, scale):
        read(*ops)
        return kernel_layout(oaca.oaca_attention_plain(*ops, scale=scale))

    def attention_launch(q, k, v, *, scale, kv_len):
        read(q, k, v)
        return kernel_layout(attention.attention_plain(q, k, v, scale=scale, kv_len=kv_len))

    def groupnorm_launch(x, w, b, s, t, **kw):
        read(x, w, b, s, t)
        return groupnorm.group_norm_plain(x, w, b, scale=s, shift=t, **kw)

    monkeypatch.setattr(oaca, "launch", oaca_launch)
    monkeypatch.setattr(attention, "launch", attention_launch)
    monkeypatch.setattr(groupnorm, "launch", groupnorm_launch)


def _route_cases():
    """(name, Function call, plain call, operands that require grad)."""
    rnd = np.random.RandomState(0)

    def leaf(*shape):
        return torch.as_tensor(_draw(rnd, *shape)).requires_grad_()

    o = [leaf(2, 2, 12, 32), leaf(2, 2, 12, 32), leaf(2, 2, 12, 32), leaf(2, 2, 5, 64), leaf(2, 2, 12, 32),
         leaf(2, 2, 5, 32)]
    a = [leaf(2, 2, 12, 16), leaf(2, 2, 12, 16), leaf(2, 2, 12, 8)]
    x, w, b, proj = leaf(2, 4, 8, 32), leaf(32), leaf(32), leaf(2, 64)
    s, t = proj.chunk(2, dim=-1)
    return [
        ("oaca", lambda: oaca.OacaAttention.apply(0.35, *o),
         lambda: oaca.oaca_attention_plain(*o, scale=0.35), o),
        ("attention", lambda: attention.Attention.apply(0.25, 9, *a),
         lambda: attention.attention_plain(*a, scale=0.25, kv_len=9), a),
        ("groupnorm", lambda: groupnorm.GroupNorm.apply(8, 1e-6, True, x, w, b, s, t),
         lambda: groupnorm.group_norm_plain(x, w, b, num_groups=8, eps=1e-6, scale=s, shift=t, silu=True),
         [x, w, b, proj]),
    ]


@pytest.mark.parametrize("route", ["oaca", "attention", "groupnorm"])
def test_function_gradients_equal_autograd_through_plain(monkeypatch, route):
    _plain_launches(monkeypatch)
    _, fn, plain, leaves = next(c for c in _route_cases() if c[0] == route)
    out = fn()
    assert out.grad_fn is not None and type(out.grad_fn).__name__.endswith("Backward")
    want_out = plain()
    g = torch.randn(out.shape[0], out.shape[2], out.shape[1], *out.shape[3:]).transpose(1, 2) \
        if out.ndim == 4 and route != "groupnorm" else torch.randn(out.shape)
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(want_out, leaves, g)
    for d, e in zip(got, want):
        torch.testing.assert_close(d, e, rtol=1e-6, atol=1e-6)


def test_every_route_returns_a_grad_fn_for_an_operand_that_requires_grad():
    """The wrappers on the CPU (plain versions) and the Functions: a
    ``grad_fn`` whenever one operand requires grad, none under
    ``inference_mode``."""
    rnd = np.random.RandomState(1)
    t = lambda *s: torch.as_tensor(_draw(rnd, *s))  # noqa: E731
    ops = [t(1, 2, 8, 32), t(1, 2, 8, 32), t(1, 2, 8, 32), t(1, 2, 3, 64), t(1, 2, 8, 32), t(1, 2, 3, 32)]
    qkv = [t(1, 2, 8, 16) for _ in range(3)]
    x, w = t(1, 4, 4, 32), t(32)
    calls = [
        lambda: oaca.oaca_attention(*ops, scale=0.3),
        lambda: attention.attention(*qkv, scale=0.3),
        lambda: groupnorm.group_norm(x, w, None, num_groups=8, eps=1e-6),
    ]
    for leaf, call in zip((ops[3], qkv[1], w), calls):
        leaf.requires_grad_()
        assert call().grad_fn is not None
        with torch.inference_mode():
            assert call().grad_fn is None
        leaf.requires_grad_(False)
        assert call().grad_fn is None
