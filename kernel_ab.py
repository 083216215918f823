#!/usr/bin/env python3
"""Time the port's GN flash-attention and GN softmax kernels of one or more
checkouts on one GPU, in turns, at the static path's shapes.

    python3 kernel_ab.py PARENT_ROOT . . PARENT_ROOT

Each root runs in a process of its own (every checkout names its package
``repro_torch``), builds its kernels from its own sources and prints one
JSON line: device ms per call (torch.profiler, the CUDA kernels the calls
ran) of ``gn_attention`` at the perplexity forward's shape (B 8, H 16,
Hkv 8, S 1056, D 128, causal) in bf16 and in f32, of ``gn_softmax`` at a
decode step's rows (128, 1056) and at the prefill's rows (131072, 1024)
f32, and of the library calls on the same inputs (SDPA, ``torch.softmax``).
The inputs come from one seed, so every root sees the same tensors.  Two
versions compare only within one run of this script, on one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ITERS = {"attention": 10, "softmax_decode": 200, "softmax_prefill": 10}


def device_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            total += t if t is not None else e.self_cuda_time_total
    if total <= 0:
        raise RuntimeError("the profiler saw no device time")
    return total / iters / 1e3


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.gn_attention import ops as fa
    from repro_torch.kernels.gn_softmax import ops as sm

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"root": root}
    b, h, hkv, s, d = 8, 16, 8, 1056, 128
    q = torch.randn(b, h, s, d, generator=gen, device="cuda")
    k = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        res[f"gn_attention_{name}_ms"] = device_ms(
            lambda: fa.gn_attention(qq, kk, vv, causal=True), ITERS["attention"])
        res[f"sdpa_{name}_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True),
            ITERS["attention"])
    del q, k, v
    for label, rows, cols, pos in (("decode", 128, 1056, 1040), ("prefill", 131072, 1024, None)):
        x = torch.randn(rows, cols, generator=gen, device="cuda") * 3
        col = torch.arange(cols, device="cuda")[None]
        vis = (torch.full((rows, 1), pos, device="cuda") if pos is not None
               else (torch.arange(rows, device="cuda") % cols)[:, None])
        x = x.masked_fill_(col > vis, -1e30)
        iters = ITERS[f"softmax_{label}"]
        res[f"gn_softmax_{label}_ms"] = device_ms(lambda: sm.gn_softmax(x), iters)
        res[f"torch_softmax_{label}_ms"] = device_ms(lambda: torch.softmax(x, dim=-1), iters)
    return res


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
