#!/usr/bin/env python3
"""Device ms of the attention kernel and of OACA at the kernel table's
shapes on one card, float32 (TF32 off) and bfloat16, with SDPA on the same
operands beside every row unless ``--no-library``.

Attention: the EfficientUNet's d_block4 (8 heads of 64 over 512 tokens) and
u_block4 (8 of 32), kitti-360's d_block4 (1,024 tokens), the GLIDE v6 ds4
block (8 heads of 32, 13 encoder tokens in front of 2,048), and
``OpenAIUNet``'s wide heads (one of 256 over 2,048 tokens, one of 512 over
512, two of 384 over 1,000 with ``kv_len`` 777).  OACA with the 13-token
layout strip: head dims 32³ at ds4 (8 heads over 2,048 tokens, the main
path), ds8 (16 heads over 512) and a ragged 1,000, (32, 64, 32) at ds4, the
``sp`` = 2 shard (1,024 queries over 2,048 gathered keys), and the v0
stack's 64³ at ds4, ragged 1,000 and its ``sp`` = 2 shard (a checkout whose
64³ route takes no gathered keys prints that row as ``refused``).  B = 8 everywhere; operands laid out as
the blocks hand them (per-head views of one fused projection), each timed as
``chip_smoke.py`` times a kernel row (CUDA events over 20 calls after 3
warm-ups, queued behind a ~30 ms sleep).

``--repo DIR`` imports ``lidarcrafter_tpu_torch`` from another checkout (say
a parent commit unpacked with ``git archive``), so that two versions are
compared within one call on one card: run them in turn, as parent, change,
change, parent.  Prints one JSON line a row (the route the wrapper names),
then the card's ``nvidia-smi`` name and power limit.

Usage: ``python3 scripts/kernel_pace.py [--repo DIR] [--tag NAME] [--no-library]``
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

BATCH, L2 = 8, 13
# label, heads, Lq, Lkv, kv_len, head dim, encoder tokens in front (GLIDE)
ATTENTION = (("d_block4", 8, 512, 512, None, 64, 0), ("u_block4", 8, 512, 512, None, 32, 0),
             ("kitti-360 d_block4", 8, 1024, 1024, None, 64, 0), ("glide ds4", 8, 2048, 2048, None, 32, L2),
             ("wide d=256", 1, 2048, 2048, None, 256, 0), ("wide d=512", 1, 512, 512, None, 512, 0),
             ("wide ragged d=384", 2, 1000, 1000, 777, 384, 0))
# label, heads, Lq, Lk, (content, positional) head dims
OACA = (("ds4 32^3", 8, 2048, 2048, (32, 32)), ("ds8 32^3", 16, 512, 512, (32, 32)),
        ("ragged 32^3", 8, 1000, 1000, (32, 32)), ("ds4 (32, 64, 32)", 8, 2048, 2048, (32, 64)),
        ("sp shard 32^3", 8, 1024, 2048, (32, 32)), ("v0 ds4 64^3", 8, 2048, 2048, (64, 64)),
        ("v0 ragged 64^3", 8, 1000, 1000, (64, 64)), ("v0 sp shard 64^3", 8, 1024, 2048, (64, 64)))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(5e7))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def route(module, *dims_and_dtype) -> str | None:
    """The route the wrapper names for a call, None where the checkout's
    wrapper names none (a parent from before the Hopper core)."""
    return module.route(*dims_and_dtype) if hasattr(module, "route") else None


def attention_operands(H, Lq, d, enc, dtype, gen):
    """q, k, v as per-head views of one (B, L, 3·H·d) projection; with
    ``enc`` encoder tokens, GLIDE's per-head [q|k|v] packing and the
    encoder's K/V in front of the image's."""
    import torch

    C = H * d
    if not enc:
        qkv = torch.randn(BATCH, Lq, 3 * C, generator=gen, device="cuda").to(dtype)
        return tuple(t.reshape(BATCH, Lq, H, d).transpose(1, 2) for t in qkv.split(C, dim=-1))
    qkv = torch.randn(BATCH, Lq, 3 * C, generator=gen, device="cuda").to(dtype).view(BATCH, Lq, H, 3 * d)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    ekv = torch.randn(BATCH, enc, 2 * C, generator=gen, device="cuda").to(dtype).view(BATCH, enc, H, 2 * d)
    ek, ev = (t.transpose(1, 2) for t in ekv.split(d, dim=-1))
    return q, torch.cat([ek, k], dim=2), torch.cat([ev, v], dim=2)


def oaca_operands(H, Lq, Lk, dc, dp, dtype, gen):
    """(q_c, ipe, k_c, k_l, v_c, v_l), ipe_k: the queries' per-head views of
    one fused projection; keys and values their own (gathered, as the ``sp``
    mesh hands them) where Lk != Lq, with their positional rows ``ipe_k``."""
    import torch

    heads = lambda t, L: t.reshape(BATCH, L, H, -1).transpose(1, 2)  # noqa: E731
    qkv = torch.randn(BATCH, Lq, 3 * H * dc, generator=gen, device="cuda").to(dtype)
    q_c, k_c, v_c = (heads(t, Lq) for t in qkv.chunk(3, dim=-1))
    ipe = heads(torch.randn(BATCH, Lq, H * dp, generator=gen, device="cuda").to(dtype), Lq)
    ipe_k = None
    if Lk != Lq:
        k_c, v_c = (heads(t, Lk) for t in torch.randn(BATCH, Lk, 2 * H * dc, generator=gen, device="cuda")
                    .to(dtype).chunk(2, dim=-1))
        ipe_k = heads(torch.randn(BATCH, Lk, H * dp, generator=gen, device="cuda").to(dtype), Lk)
    k_l = torch.randn(BATCH, H, L2, dc + dp, generator=gen, device="cuda").to(dtype)
    v_l = torch.randn(BATCH, H, L2, dc, generator=gen, device="cuda").to(dtype)
    return (q_c, ipe, k_c, k_l, v_c, v_l), ipe_k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--tag", default="change", help="name printed on every row")
    ap.add_argument("--no-library", action="store_true", help="skip the SDPA timings")
    args = ap.parse_args()
    sys.path.insert(0, args.repo)
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention, loader, oaca

    if not torch.cuda.is_available():
        print("kernel_pace: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    loader.load_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, H, L, Lkv, kv_len, d, enc in ATTENTION:
            q, k, v = attention_operands(H, L, d, enc, dtype, gen)
            scale = 1 / math.sqrt(d)
            row = {"tag": args.tag, "kernel": "attention", "shape": label, "dtype": dname,
                   "route": route(attention, d, d, dtype),
                   "ms": time_ms(lambda: attention.attention(q, k, v, scale=scale, kv_len=kv_len))}
            if not args.no_library:
                Lk = k.shape[2]
                mask = None if kv_len is None else (torch.arange(Lk, device="cuda") < kv_len).expand(L, Lk)
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                                     scale=scale))
            print(json.dumps(row), flush=True)
        for label, H, L, Lk, (dc, dp) in OACA:
            ops, ipe_k = oaca_operands(H, L, Lk, dc, dp, dtype, gen)
            kw = {} if ipe_k is None else {"ipe_k": ipe_k}
            scale = 1 / math.sqrt(math.sqrt(dc + dp))
            row = {"tag": args.tag, "kernel": "oaca", "shape": label, "dtype": dname,
                   "route": route(oaca, dc, dp, dc, dtype)}
            try:
                row["ms"] = time_ms(lambda: oaca.oaca_attention(*ops, scale=scale, **kw))
            except ValueError as e:  # an older checkout's wrapper refusing the shape
                row["refused"] = str(e)
            if not args.no_library:
                q_c, ipe, k_c, k_l, v_c, v_l = ops
                q_img = torch.cat([q_c, ipe], -1)
                k_mix = torch.cat([torch.cat([k_c, ipe if ipe_k is None else ipe_k], -1), k_l], 2)
                v_mix = torch.cat([v_c, v_l], 2)
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q_img, k_mix, v_mix,
                                                                                     scale=scale ** 2))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
