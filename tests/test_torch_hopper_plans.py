"""What the attention and OACA wrappers decide on the host for the Hopper
core (``csrc/hopper_flash.cuh``): which route a (head dims, dtype) takes, the
core's tiling and shared memory at every pair of attention head dims and at
every OACA instantiation, and the operands a TMA tensor map cannot address.
No card is needed: the plans are the C++ ones mirrored in Python
(``chip_smoke.py`` holds the mirrors to the library's ``attention_plan`` /
``oaca_plan`` on the card)."""

import pytest
import torch

from lidarcrafter_tpu_torch.kernels import attention, loader, oaca

DTYPES = [torch.float32, torch.bfloat16]
WIDE_DIMS = [(dqk, dv) for dqk in range(8, 513, 8) for dv in range(8, 513, 8) if max(dqk, dv) > 128]
NARROW_DIMS = [(dqk, dv) for dqk in range(8, 129, 8) for dv in range(8, 129, 8)]
CORE = {torch.float32: "tma mma 3xTF32", torch.bfloat16: "wgmma bf16"}
MMA = {torch.float32: "mma 3xTF32", torch.bfloat16: "mma bf16"}


def smem_limit(blocks: int) -> int:
    return loader.SMEM_LIMIT if blocks == 1 else loader.SMEM_LIMIT2


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_route_follows_the_head_dims(dtype):
    """bf16 runs on the core at every head dim; float32 up to 128 stays on
    the cp.async + mma.sync loader (the fixed rule), above it on the core."""
    narrow = MMA[dtype] if dtype == torch.float32 else CORE[dtype]
    assert [attention.route(dqk, dv, dtype) for dqk, dv in ((32, 32), (64, 64), (128, 128), (16, 128))] == [narrow] * 4
    assert [attention.route(dqk, dv, dtype) for dqk, dv in ((136, 136), (256, 256), (128, 256), (512, 128),
                                                            (384, 384), (512, 512))] == [CORE[dtype]] * 6


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_plan_fits_shared_memory_at_every_head_dim_pair(dtype):
    """Every (dqk, dv) from 8 to 512 in steps of 8 with one above 128: at
    least one K/V stage, at most 227 KB of shared memory, one block an SM;
    bf16 up to 256 gives each consumer 64 of 128 rows and the whole dv,
    everything else splits a 64-row tile, each consumer's O at least half of
    dv wide."""
    f32 = dtype == torch.float32
    for dqk, dv in WIDE_DIMS:
        p = attention.plan(dqk, dv, dtype)
        assert 1 <= p.layout.stages <= 4 and p.layout.smem <= loader.SMEM_LIMIT and p.blocks == 1, (dqk, dv, p)
        assert p.split == (f32 or max(dqk, dv) > 256), (dqk, dv, p)
        assert p.nv in (128, 256) and p.nv * (2 if p.split else 1) >= dv, (dqk, dv, p)
        assert p.bk in ((16, 32) if f32 else (32,) if p.split else (80,)), (dqk, dv, p)


@pytest.mark.parametrize("dtype,dims,plan", [
    (torch.bfloat16, (256, 256), (False, 80, 256, 2, 230536)),
    (torch.bfloat16, (512, 512), (True, 32, 256, 2, 230536)),
    (torch.bfloat16, (384, 384), (True, 32, 256, 2, 197768)),
    (torch.float32, (256, 256), (True, 32, 128, 2, 230536)),
    (torch.float32, (512, 512), (True, 16, 256, 1, 214152)),
    (torch.float32, (384, 384), (True, 16, 256, 2, 230536)),
])
def test_wide_plan_at_the_openai_unet_shapes(dtype, dims, plan):
    """The shapes of the kernel table (d = 256, 512 and the ragged 384):
    split, key tile, O width, stages and bytes, as the header of
    ``csrc/attention.cu`` states them."""
    p = attention.plan(*dims, dtype)
    assert (p.split, p.bk, p.nv, p.layout.stages, p.layout.smem) == plan


@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_plan_fits_shared_memory_at_every_head_dim_pair(dtype):
    """Every (dqk, dv) up to 128 in steps of 8: not split, both dims padded
    to the next of 32, 64, 128 (O as wide), at least one stage within the
    shared memory of its blocks an SM; bf16 at 32 two blocks an SM with
    64-key tiles, else one, with 128-key tiles in bf16 and 64 in float32."""
    f32 = dtype == torch.float32
    for dqk, dv in NARROW_DIMS:
        p = attention.plan(dqk, dv, dtype)
        d = next(w for w in (32, 64, 128) if max(dqk, dv) <= w)
        assert not p.split and p.nv == d, (dqk, dv, p)
        assert (p.bk, p.blocks) == ((64, 1) if f32 else (64, 2) if d == 32 else (128, 1)), (dqk, dv, p)
        assert 1 <= p.layout.stages <= 4 and p.layout.smem <= smem_limit(p.blocks), (dqk, dv, p)


@pytest.mark.parametrize("dtype,d,plan", [
    # (key tile, O width, blocks an SM, stages, dynamic shared memory)
    (torch.bfloat16, 32, (64, 32, 2, 4, 42120)),     # 64-byte chunks: q 2 x 4 KB, stages of 4 + 4 KB
    (torch.bfloat16, 64, (128, 64, 1, 4, 148616)),
    (torch.bfloat16, 128, (128, 128, 1, 3, 230536)),
    (torch.float32, 32, (64, 32, 1, 4, 83080)),
    (torch.float32, 64, (64, 64, 1, 4, 165000)),
    (torch.float32, 128, (64, 128, 1, 2, 197768)),
])
def test_narrow_plan_at_the_kernel_table_shapes(dtype, d, plan):
    """Head dims 32, 64 and 128 (u_block4 / GLIDE, d_block4, the widest
    narrow head), as the header of ``csrc/attention.cu`` states them."""
    p = attention.plan(d, d, dtype)
    assert (p.bk, p.nv, p.blocks, p.layout.stages, p.layout.smem) == plan


@pytest.mark.parametrize("dtype,stages,smem", [(torch.bfloat16, 4, 230536), (torch.float32, 3, 214152)])
def test_oaca_128_wide_route_and_plan(dtype, stages, smem):
    """(64, 64, 64) on the core in both dtypes, 128-key tiles in bf16 and 64
    in float32, one block an SM."""
    assert oaca.route(64, 64, 64, dtype) == CORE[dtype]
    p = oaca.plan(64, 64, dtype)
    assert (p.bk, p.blocks, p.layout) == (128 if dtype == torch.bfloat16 else 64, 1, loader.HopperLayout(stages, smem))


@pytest.mark.parametrize("dtype,dp,plan", [
    # (key tile, blocks an SM, stages, dynamic shared memory); a q / k row is
    # q_c's chunk beside ipe's, each 64 bytes wide where the part is
    (torch.bfloat16, 32, (64, 2, 4, 66696)),   # two 64-byte chunks
    (torch.bfloat16, 16, (64, 2, 4, 66696)),   # the 32 build, ipe's chunk half zero-filled
    (torch.bfloat16, 64, (128, 1, 4, 156808)),  # 128-byte ipe chunk, 64-byte q_c chunk
    (torch.float32, 32, (64, 1, 4, 132232)),   # two 128-byte chunks
    (torch.float32, 16, (64, 1, 4, 107656)),   # 128-byte q_c, 64-byte ipe
    (torch.float32, 64, (64, 1, 4, 181384)),   # three 128-byte chunks
])
def test_oaca_32_wide_routes_and_plans(dtype, dp, plan):
    """Head dims (32, dp, 32): bf16 on the core, float32 on the cp.async +
    mma.sync loader (the fixed rule); the core's plan either way (the
    float32 one is what ``launch(on="core")`` runs)."""
    assert oaca.route(32, dp, 32, dtype) == (MMA if dtype == torch.float32 else CORE)[dtype]
    p = oaca.plan(32, dp, dtype)
    assert (p.bk, p.blocks, p.layout.stages, p.layout.smem) == plan
    assert p.layout.smem <= smem_limit(p.blocks)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 32)])
@pytest.mark.parametrize("stride_bytes,sizes,ok", [
    ((256, 2**38, 256), (1, 2, 8), True),          # 2^38 bytes between heads: addressable
    ((256, 2**40, 256), (1, 2, 8), False),         # 2^40 bytes between heads: not
    ((2**40, 2048, 256), (1, 2, 8), True),         # a size-1 batch's stride is never used
    ((2**40, 2048, 256), (2, 2, 8), False),
    ((256, 2048, 2**40), (1, 2, 8), False),        # rows 2^40 bytes apart
])
def test_tma_refuses_strides_it_cannot_address(stride_bytes, sizes, ok, dtype, d):
    """The same limits for the 128-byte boxes of a float32 head of 64 (128B
    swizzle) and the 64-byte ones of a bfloat16 head of 32 (64B swizzle)."""
    elt = torch.finfo(dtype).bits // 8
    t = torch.empty_strided((*sizes, d), tuple(b // elt for b in stride_bytes) + (1,), dtype=dtype, device="meta")
    assert loader.tma_addressable(t) is ok
