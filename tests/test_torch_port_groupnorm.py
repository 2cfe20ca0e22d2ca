"""The GroupNorm wrapper's operand form on the CPU: ``group_norm`` /
``group_norm_plain`` take the modules' raw operands (the norm's weight and
bias, the conditioning's scale and shift as strided views of one
projection, any of them absent) and fold them themselves, and the modules
hand them over with no tensor op of their own.  Also the launch plan the
CUDA kernel runs (``plan``), which decides where the kernel reads the slab
once and where it merges across blocks.

Tolerances: float32 against the JAX package's ``GroupNorm32`` / ``FusedGN``
to 1e-5 of the largest output, as ``test_torch_port_kernels.py`` (O(1)
values, sums of ≤ 8192 elements in another order).  bfloat16 operands
against the JAX modules applied to the same bfloat16 values to 6e-2 of the
largest output, the limit of ``test_torch_port_bf16.py``: the JAX modules
round the affine output to bfloat16 and apply the scale-shift and SiLU in
bfloat16, the port folds in float32 and rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import lidarcrafter_tpu.models.ops as jops
from lidarcrafter_tpu_torch.kernels import groupnorm
from lidarcrafter_tpu_torch.models import ops as tops

F32_RTOL, BF16_RTOL = 1e-5, 6e-2


def _draw(B, H, W, C, seed=0):
    rnd = np.random.RandomState(seed)
    x = (rnd.standard_normal((B, H, W, C)) * 2.0 + 3.0).astype(np.float32)
    w = (1 + 0.1 * rnd.standard_normal(C)).astype(np.float32)
    b = (0.1 * rnd.standard_normal(C)).astype(np.float32)
    proj = (0.3 * rnd.standard_normal((B, 2 * C))).astype(np.float32)  # [scale | shift]
    return x, w, b, proj


def _jax(module, x, w, b, proj, silu, dtype=jnp.float32):
    """The JAX module on (B, 1, 1, C) scale and shift, parameters and inputs
    in ``dtype``; returns float32 numpy."""
    C = x.shape[-1]
    params = {}
    if w is not None:
        params = {"params": {"scale": jnp.asarray(w, dtype), "bias": jnp.asarray(b, dtype)}}
    ss = None
    if proj is not None:
        ss = tuple(jnp.asarray(h, dtype)[:, None, None, :] for h in (proj[:, :C], proj[:, C:]))
    out = module.apply(params, jnp.asarray(x, dtype), scale_shift=ss, silu=silu)
    return np.asarray(out.astype(jnp.float32))


def _plain(x, w, b, proj, silu, G, eps, dtype=torch.float32):
    """group_norm_plain on the raw operands: (C,) weight and bias and the
    ``chunk`` halves of the (B, 2C) projection (row stride 2C)."""
    t = lambda a: None if a is None else torch.as_tensor(a).to(dtype)  # noqa: E731
    s, sh = (None, None) if proj is None else t(proj).chunk(2, dim=-1)
    if s is not None:
        assert s.stride() == (2 * x.shape[-1], 1)  # a strided view, no copy
    y = groupnorm.group_norm_plain(t(x), t(w), t(b), num_groups=G, eps=eps, scale=s, shift=sh, silu=silu)
    assert y.dtype == dtype
    return y.float().numpy()


@pytest.mark.parametrize(
    "module,G,eps,affine,scale_shift,silu",
    [
        ("GroupNorm32", 32, 1e-5, True, True, True),   # ResBlockADM out_norm
        ("GroupNorm32", 32, 1e-5, True, False, True),  # in_norm
        ("FusedGN", 8, 1e-6, False, True, True),       # AdaGN: no weight, no bias
        ("FusedGN", 8, 1e-6, True, True, False),
        ("FusedGN", 8, 1e-6, True, False, False),      # attention blocks' norm
    ],
)
def test_raw_operands_match_jax_modules_f32(module, G, eps, affine, scale_shift, silu):
    x, w, b, proj = _draw(2, 8, 16, 64)
    if not affine:
        w = b = None
    proj = proj if scale_shift else None
    jmod = (jops.GroupNorm32(num_groups=G, epsilon=eps) if module == "GroupNorm32" else
            jops.FusedGN(num_groups=G, epsilon=eps, use_scale=affine, use_bias=affine))
    want = _jax(jmod, x, w, b, proj, silu)
    got = _plain(x, w, b, proj, silu, G, eps)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_RTOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("affine,scale_shift,silu", [(True, True, True), (False, True, True), (True, False, False)])
def test_raw_operands_match_jax_modules_bf16(affine, scale_shift, silu):
    x, w, b, proj = _draw(2, 8, 16, 64, seed=1)
    if not affine:
        w = b = None
    proj = proj if scale_shift else None
    jmod = jops.FusedGN(num_groups=8, epsilon=1e-6, use_scale=affine, use_bias=affine)
    want = _jax(jmod, x, w, b, proj, silu, dtype=jnp.bfloat16)
    got = _plain(x, w, b, proj, silu, 8, 1e-6, dtype=torch.bfloat16)
    want_f32 = _jax(jmod, x, w, b, proj, silu)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_RTOL * np.abs(want_f32).max())
    assert np.abs(got - want_f32).max() > 0  # it ran in bfloat16


def test_earlier_folded_call_form_gives_the_same_output():
    """``group_norm(x, γ(1+s), β(1+s)+t)`` with (B, C) f32 operands, the
    call form before the wrapper took raw operands, still works and agrees
    with the raw form."""
    x, w, b, proj = _draw(3, 4, 8, 32, seed=2)
    s, t = (torch.as_tensor(h) for h in np.split(proj, 2, axis=-1))
    tw, tb = torch.as_tensor(w), torch.as_tensor(b)
    args = dict(num_groups=8, eps=1e-6, silu=True)
    folded = groupnorm.group_norm(torch.as_tensor(x), tw * (1 + s), tb * (1 + s) + t, **args)
    raw = groupnorm.group_norm(torch.as_tensor(x), tw, tb, scale=s, shift=t, **args)
    torch.testing.assert_close(raw, folded, rtol=0, atol=1e-6)


class _Recorder(TorchDispatchMode):
    """Records every aten op dispatched outside ``group_norm``."""

    def __init__(self):
        super().__init__()
        self.ops, self.inside = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    real = tops.group_norm

    def wrapped(*args, **kwargs):
        rec.inside += 1
        try:
            return real(*args, **kwargs)
        finally:
            rec.inside -= 1

    monkeypatch.setattr(tops, "group_norm", wrapped)
    return rec


@pytest.mark.parametrize(
    "make,scale_shift",
    [(lambda: tops.GroupNorm32(64), False), (lambda: tops.GroupNorm32(64), True),
     (lambda: tops.FusedGN(64, 8, 1e-6), False), (lambda: tops.FusedGN(64, 8, 1e-6, False, False), True)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_modules_dispatch_no_op_outside_the_wrapper(recorder, make, scale_shift, dtype):
    """The scale-shift fold, the dtype casts and the contiguous copies all
    live in ``group_norm`` now: ``FusedGN`` / ``GroupNorm32`` dispatch
    nothing of their own, with the conditioning as strided views, and with
    bfloat16 parameters as the bfloat16 serving cast leaves them."""
    mod = make().to(dtype)
    x = torch.randn(2, 4, 8, 64, dtype=dtype)
    ss = tuple(torch.randn(2, 128, dtype=dtype).chunk(2, dim=-1)) if scale_shift else None
    with recorder:
        y = mod(x, scale_shift=ss, silu=True)
    assert recorder.ops == []
    assert y.shape == x.shape


def test_ada_gn_dispatches_only_its_projection(recorder):
    """``AdaGN`` dispatches exactly the ops of its ``Dense(silu(emb))``
    projection and its split, nothing for the norm itself."""
    mod = tops.AdaGN(64, 32, 8, 1e-6)
    x, emb = torch.randn(2, 4, 8, 64), torch.randn(2, 32)
    with recorder:
        mod(x, emb, silu=True)
    got = list(recorder.ops)
    recorder.ops.clear()
    with recorder:
        mod.dense_0(torch.nn.functional.silu(emb)).chunk(2, dim=-1)
    assert got == recorder.ops and got


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_covers_the_main_shapes(itemsize):
    """Token norms take one block an image (no grid sync); the large norms
    16 blocks an image at B=8 (128 of the 132 SMs), none left empty; ds8
    reads its slab once; level 0 stages part of each block and re-reads the
    rest; every plan fits the card's shared memory and thread limits."""
    B = 8
    tokens = groupnorm.plan(B, 13, 64, 32, itemsize)
    assert tokens.k == 1 and tokens.rows_per_block == 13 and tokens.read_once
    for HW, C, G in [(32 * 1024, 64, 32), (32 * 1024, 192, 32), (8 * 256, 256, 32), (4 * 128, 1024, 32),
                     (4 * 128, 512, 8), (32 * 1024, 64, 8)]:
        p = groupnorm.plan(B, HW, C, G, itemsize)
        assert p.k == 16 and p.k * p.rows_per_block >= HW > (p.k - 1) * p.rows_per_block
        assert p.smem <= groupnorm._SMEM_MAX and p.threads <= groupnorm._MAX_THREADS and p.threads % 32 == 0
        assert p.read_once == (HW * C * itemsize <= 16 * 150 * 1024)
    level0 = groupnorm.plan(B, 32 * 1024, 64, 32, itemsize)
    assert 0.4 < level0.stage_rows / level0.rows_per_block < 1


def test_plan_thresholds():
    """An image is one block below two 32 KB blocks; staged rows fill the
    shared memory the scratch leaves; B at or above the SM count keeps one
    block an image."""
    assert groupnorm.plan(2, 255, 64, 32, 4).k == 1  # 255·256 B < 2·32 KB
    assert groupnorm.plan(2, 256, 64, 32, 4).k == 2
    cap = groupnorm.plan(2, 1 << 20, 64, 32, 4).stage_rows
    assert groupnorm.plan(2, 66 * cap, 64, 32, 4).read_once
    assert not groupnorm.plan(2, 66 * (cap + 1), 64, 32, 4).read_once
    assert groupnorm.plan(200, 4096, 64, 32, 2).k == 1
    assert groupnorm.plan(8, 4096, 64, 32, 4, num_sms=64).k == 8
