#!/usr/bin/env python3
"""Device ms of the attention kernel at ``OpenAIUNet``'s wide heads and of
OACA at the v0 stack's head dims 64 on one card, float32 (TF32 off) and
bfloat16: the kernel table's shapes (B=8; one head of 256 over 2,048
tokens, one of 512 over 512, two of 384 over 1,000 with ``kv_len`` 777;
OACA 8 heads over 2,048 and a ragged 1,000 tokens with the 13-token layout
strip), operands laid out as the blocks hand them (per-head views of one
fused projection), each timed as ``chip_smoke.py`` times a kernel row (CUDA
events over 20 calls after 3 warm-ups, queued behind a ~30 ms sleep), with
SDPA on the same operands beside the attention rows unless
``--no-library``.

``--repo DIR`` imports ``lidarcrafter_tpu_torch`` from another checkout
(say a parent commit unpacked with ``git archive``), so that two versions
are compared within one call on one card: run them in turn, as parent,
change, change, parent.  Prints one JSON line a row, then the card's
``nvidia-smi`` name and power limit.

Usage: ``python3 scripts/kernel_pace.py [--repo DIR] [--tag NAME] [--no-library]``
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

WIDE = (("wide d=256", 1, 2048, None, 256), ("wide d=512", 1, 512, None, 512),
        ("wide ragged d=384", 2, 1000, 777, 384))
OACA = (("v0 ds4", 2048), ("v0 ragged", 1000))
BATCH, OACA_HEADS, OACA_D, L2 = 8, 8, 64, 13


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
        for label, H, L, kv_len, d in WIDE:
            qkv = torch.randn(BATCH, L, 3 * H * d, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.reshape(BATCH, L, H, d).transpose(1, 2) for t in qkv.split(H * d, dim=-1))
            scale = 1 / math.sqrt(d)
            row = {"tag": args.tag, "kernel": "attention", "shape": label, "dtype": dname,
                   "route": route(attention, d, d, dtype),
                   "ms": time_ms(lambda: attention.attention(q, k, v, scale=scale, kv_len=kv_len))}
            if not args.no_library:
                mask = None if kv_len is None else (torch.arange(L, device="cuda") < kv_len).expand(L, L)
                row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                                     scale=scale))
            print(json.dumps(row), flush=True)
        for label, L in OACA:
            C = OACA_HEADS * OACA_D
            heads = lambda t: t.reshape(BATCH, L, OACA_HEADS, OACA_D).transpose(1, 2)  # noqa: E731
            q_c, k_c, v_c = (heads(t) for t in torch.randn(BATCH, L, 3 * C, generator=gen, device="cuda")
                             .to(dtype).chunk(3, dim=-1))
            ipe = heads(torch.randn(BATCH, L, C, generator=gen, device="cuda").to(dtype))
            k_l = torch.randn(BATCH, OACA_HEADS, L2, 2 * OACA_D, generator=gen, device="cuda").to(dtype)
            v_l = torch.randn(BATCH, OACA_HEADS, L2, OACA_D, generator=gen, device="cuda").to(dtype)
            scale = 1 / math.sqrt(math.sqrt(2 * OACA_D))
            ms = time_ms(lambda: oaca.oaca_attention(q_c, ipe, k_c, k_l, v_c, v_l, scale=scale))
            print(json.dumps({"tag": args.tag, "kernel": "oaca", "shape": label, "dtype": dname,
                              "route": route(oaca, OACA_D, OACA_D, OACA_D, dtype), "ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
