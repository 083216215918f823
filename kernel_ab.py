#!/usr/bin/env python3
"""Time the port's kernels of one or more checkouts on one GPU, in turns.

    python3 kernel_ab.py PARENT_ROOT . . PARENT_ROOT

Each root runs in a process of its own (every checkout names its package
``repro_torch``), builds its kernels from its own sources and prints one
JSON line of device ms per call (torch.profiler, the CUDA kernels the calls
ran):
- ``gn_attention`` at the perplexity forward's shape (B 8, H 16, Hkv 8,
  S 1056, D 128, causal) in bf16 and in f32, and SDPA on the same inputs;
- ``gn_softmax`` at a decode step's rows (128, 1056) and at the prefill's
  rows (131072, 1024) f32, and ``torch.softmax`` on the same inputs;
- ``gn_paged_attention`` at the serving tick's shape (chip_smoke.py's phase
  2 inputs: 8 sequences of up to 1056 tokens, H 16, Hkv 8, D 128, block 16,
  shuffled tables with stale ids past each length, one empty sequence),
  bf16 q over bf16 arenas (``paged_fp``) and over int8 arenas quantized by
  the root's ``paged_quant_write`` (``paged_int8``), at C = 16 and C = 1:
  the whole call (``_ms``) and the merge kernel of the chain ranges alone
  (``_merge_ms``), under the root's own chain-split rule; where the root's
  wrapper has ``MAX_RANGE_PAGES``, the same calls under each rule by name:
  ranges sized by the card alone (``_card``) and capped at ``CAP_PAGES``
  pages (``_cap``).
The inputs come from one seed, so every root sees the same tensors.  Two
versions compare only within one run of this script, on one card.

    python3 kernel_ab.py --ticks ROOT

serves chip_smoke.py's phase-4 workload (full-width internlm2-1.8b, random
weights from seed 0, 8 slots, chunk 16, block 16, 16 requests of 32..1024
prompt tokens, 32 new tokens each) through ROOT's continuous engine once to
warm up, then four times under a CUDA-only profiler with the chain-split
rules in turns (the card-sized rule, capped at ``CAP_PAGES``, capped, the
card-sized rule): one JSON line a turn with the mean tick ms, the device
busy seconds and the paged read's device seconds (read and merge).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ITERS = {"attention": 10, "softmax_decode": 200, "softmax_prefill": 10, "paged": 50}
CAP_PAGES = 8  # the capped chain-split rule: at most two 64-key tiles a range


def device_ms(fn, iters: int, only: str | None = None) -> float:
    """Device ms per call; ``only``: just the kernels whose name holds it."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, False
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            seen |= (t if t is not None else e.self_cuda_time_total) > 0
            if only is None or only in e.key:
                total += t if t is not None else e.self_cuda_time_total
    if not seen:
        raise RuntimeError("the profiler saw no device time")
    return total / iters / 1e3


def paged_inputs(c: int, int8: bool):
    """chip_smoke.py's attn_inputs(c, bfloat16) draw: N 8, H 16, Hkv 8,
    D 128, block 16, max_bt 66; int8 arenas through ``paged_quant_write``."""
    import numpy as np
    import torch

    from repro_torch.models import attention as attention_mod

    n, h, hkv, d, bs, max_bt = 8, 16, 8, 128, 16, 66
    rng = np.random.default_rng(c)
    lengths = rng.integers(1, max_bt * bs + 1, size=n)
    lengths[3] = 0
    n_valid = np.where(lengths > 0, np.minimum(rng.integers(1, c + 1, size=n), lengths), 0)
    need = [-(-int(L) // bs) for L in lengths]
    nb = sum(need) + 8
    perm = rng.permutation(nb)
    tables = rng.integers(0, nb, size=(n, max_bt))
    o = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[o:o + k]
        o += k
    gen = torch.Generator(device="cuda").manual_seed(c)
    q = torch.randn(n, c, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(nb, bs, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(nb, bs, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    ints = [torch.as_tensor(a, dtype=torch.int32).cuda() for a in (tables, lengths - n_valid,
                                                                   n_valid)]
    if not int8:
        return (q, k, v, *ints), {}
    arenas, scales = [], []
    for x in (k, v):
        q8 = torch.zeros((nb + 1) * bs, hkv, d, dtype=torch.int8, device="cuda")
        sc = torch.zeros(nb + 1, device="cuda")
        attention_mod.paged_quant_write(q8, sc, x.reshape(nb * bs, hkv, d),
                                        torch.arange(nb * bs, device="cuda"), bs)
        arenas.append(q8.view(nb + 1, bs, hkv, d))
        scales.append(sc)
    return (q, *arenas, *ints), {"scales": tuple(scales)}


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
    del x
    from repro_torch.kernels.gn_paged_attention import ops as pa

    # the root's own rule, then (where it has the knob) each rule by name
    knob = hasattr(pa, "MAX_RANGE_PAGES")
    own = getattr(pa, "MAX_RANGE_PAGES", None)
    rules = [("", own)] + ([("_card", None), ("_cap", CAP_PAGES)] if knob else [])
    for mode in ("fp", "int8"):
        for c in (16, 1):
            args, kw = paged_inputs(c, mode == "int8")
            for suffix, cap in rules:
                if knob:
                    pa.MAX_RANGE_PAGES = cap
                key = f"paged_{mode}_c{c}{suffix}"
                res[f"{key}_ms"] = device_ms(lambda: pa.gn_paged_attention_chunk(*args, **kw),
                                             ITERS["paged"])
                res[f"{key}_merge_ms"] = device_ms(
                    lambda: pa.gn_paged_attention_chunk(*args, **kw), ITERS["paged"], "merge")
            del args, kw
    return res


def ticks(root: str) -> list[dict]:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.gn_paged_attention import ops as pa
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.workload import required_max_seq, seeded_requests

    model = make_model(get_config("internlm2-1.8b"))
    reqs = seeded_requests(model.cfg.vocab, 16, 32, 1024, 32, 1, 0)
    engine = ContinuousEngine(model, model.init(0, "cuda"), num_slots=8,
                              max_seq=required_max_seq(reqs), chunk=16, block_size=16,
                              device="cuda")
    engine.run(reqs)
    out = []
    for cap in (None, CAP_PAGES, CAP_PAGES, None):
        pa.MAX_RANGE_PAGES = cap
        engine.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            engine.run(reqs)
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                t = getattr(e, "self_device_time_total", None)
                us[e.key] = t if t is not None else e.self_cuda_time_total
        paged = {k: v for k, v in us.items() if "gn_paged_attention" in k}
        out.append({"root": root, "max_range_pages": cap,
                    "mean_tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log])),
                    "ticks": len(engine.tick_log), "device_busy_s": sum(us.values()) / 1e6,
                    "paged_read_s": sum(v for k, v in paged.items() if "merge" not in k) / 1e6,
                    "paged_merge_s": sum(v for k, v in paged.items() if "merge" in k) / 1e6})
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])))
        return 0
    if len(argv) == 2 and argv[0] == "--ticks":
        for line in ticks(argv[1]):
            print(json.dumps(line))
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
