"""What the attention and OACA wrappers decide on the host for the Hopper
core (``csrc/hopper_flash.cuh``): which route a (dqk, dv, dtype) takes, the
tiling and shared memory of the wide route at every pair of head dims, OACA's
128-wide plan, and the operands a TMA tensor map cannot address.  No card is
needed: the plans are the C++ ones mirrored in Python (``chip_smoke.py``
holds the mirror to the library's ``attention_wide_plan`` on the card)."""

import pytest
import torch

from lidarcrafter_tpu_torch.kernels import attention, loader, oaca

DTYPES = [torch.float32, torch.bfloat16]
WIDE_DIMS = [(dqk, dv) for dqk in range(8, 513, 8) for dv in range(8, 513, 8) if max(dqk, dv) > 128]


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_route_follows_the_head_dims(dtype):
    f32 = dtype == torch.float32
    narrow, wide = ("mma 3xTF32", "tma mma 3xTF32") if f32 else ("mma bf16", "wgmma bf16")
    assert [attention.route(dqk, dv, dtype) for dqk, dv in ((32, 32), (64, 64), (128, 128), (16, 128))] == [narrow] * 4
    assert [attention.route(dqk, dv, dtype) for dqk, dv in ((136, 136), (256, 256), (128, 256), (512, 128),
                                                            (384, 384), (512, 512))] == [wide] * 6


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_plan_fits_shared_memory_at_every_head_dim_pair(dtype):
    """Every (dqk, dv) from 8 to 512 in steps of 8 with one above 128: at
    least one K/V stage, at most 227 KB of shared memory; bf16 up to 256
    gives each consumer 64 of 128 rows and the whole dv, everything else
    splits a 64-row tile, each consumer's O at least half of dv wide."""
    f32 = dtype == torch.float32
    for dqk, dv in WIDE_DIMS:
        p = attention.wide_plan(dqk, dv, dtype)
        assert 1 <= p.layout.stages <= 4 and p.layout.smem <= loader.SMEM_LIMIT, (dqk, dv, p)
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
    p = attention.wide_plan(*dims, dtype)
    assert (p.split, p.bk, p.nv, p.layout.stages, p.layout.smem) == plan


@pytest.mark.parametrize("dtype,stages,smem", [(torch.bfloat16, 4, 230536), (torch.float32, 3, 214152)])
def test_oaca_128_wide_route_and_plan(dtype, stages, smem):
    f32 = dtype == torch.float32
    assert oaca.route(64, 64, 64, dtype) == ("tma mma 3xTF32" if f32 else "wgmma bf16")
    for dims in ((32, 32, 32), (32, 16, 32), (32, 64, 32)):
        assert oaca.route(*dims, dtype) == ("mma 3xTF32" if f32 else "mma bf16")
    assert oaca.hopper_layout(dtype) == loader.HopperLayout(stages, smem)


@pytest.mark.parametrize("stride_elems,sizes,ok", [
    ((64, 2**36, 64), (1, 2, 8), True),         # 2^38 bytes between heads: addressable
    ((64, 2**38, 64), (1, 2, 8), False),        # 2^40 bytes between heads: not
    ((2**38, 512, 64), (1, 2, 8), True),        # a size-1 batch's stride is never used
    ((2**38, 512, 64), (2, 2, 8), False),
    ((64, 512, 2**38), (1, 2, 8), False),       # rows 2^40 bytes apart
])
def test_tma_refuses_strides_it_cannot_address(stride_elems, sizes, ok):
    t = torch.empty_strided((*sizes, 64), (*stride_elems, 1), device="meta")
    assert loader.tma_addressable(t) is ok
