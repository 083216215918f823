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
- ``gn_rmsnorm`` at a decode step's (8, 2048), a tick's (128, 2048) and
  the forward's (8448, 2048) rows, bf16, in RMS mode (``norm_rms``) and in
  LayerNorm mode with a beta (``norm_ln``), with ``F.rms_norm`` on the same
  inputs, and the host-inclusive time of the RMS call (``_call_ms``, CUDA
  events around a loop of calls); the residual add and the norm at 128 and
  8448 rows (``add_norm``): the fused call where the root's wrapper has
  ``gn_add_rmsnorm``, else the eager add and the norm.
The inputs come from one seed, so every root sees the same tensors.  Two
versions compare only within one run of this script, on one card.

    python3 kernel_ab.py --forward ROOT

runs chip_smoke.py's phase-5 perplexity forward (full-width internlm2-1.8b,
random weights from seed 0, 8 x 1056 tokens from seed 0) through ROOT's
model: one warm-up, five runs timed on the host clock around synchronized
work (``host_ms``, their median), then one under a CUDA-only profiler: the
device busy ms and the ms and calls of the norm kernel and of the eager
adds (one JSON line).

    python3 kernel_ab.py --norm-layouts ROOT

times ROOT's norm and its fused add + norm in each layout that holds the
row, forced, at 8..16896 rows of 2048 columns (bf16 RMS and LayerNorm, f32
RMS) and of 7168 (bf16 RMS), beside a plain copy of the norm's bytes: the
measurements behind the kernel's layout pick (one JSON line a shape).

    python3 kernel_ab.py --ticks ROOT

serves chip_smoke.py's phase-4 workload (full-width internlm2-1.8b, random
weights from seed 0, 8 slots, chunk 16, block 16, 16 requests of 32..1024
prompt tokens, 32 new tokens each) under the chain-split rules in turns
(the card-sized rule, capped at ``CAP_PAGES``, capped, the card-sized
rule), each turn through a new engine of ROOT's, once to warm up (and
capture its graphs, where ROOT's engine replays them) and once under a
CUDA-only profiler: one JSON line a turn with the mean tick ms, the device
busy seconds and the paged read's device seconds (read and merge).

    python3 kernel_ab.py --mla PARENT_ROOT . . PARENT_ROOT

serves the same workload through full-width minicpm3-4b (62 layers, random
weights from seed 0) over the fp latent pool, each root in a process of its
own: one JSON line a root, as ``--serve``'s continuous lines.

    python3 kernel_ab.py --serve PARENT_ROOT . . PARENT_ROOT

serves phase 4's workload (above) over the fp pool and over the int8 pool
of the same block count, and times the static path (8 prompts of 1024
tokens from seed 0, 32 new tokens), through each root's engine, each root
in a process of its own, in the order given: one JSON line a root and path.
Continuous: one cold run (a root that captures graphs captures them there),
then two reset runs timed on the host clock around synchronized work (tok/s,
mean tick ms), and the graph captures where the root counts them.  Static:
``generate`` once to warm up, then twice timed (tok/s), and the decode step
alone, 16 steps after a warm-up step on the host clock around each
synchronized step (ms): the root's ``static_decoder`` where it has one (a
graph replay), else its eager ``decode_step``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ITERS = {"attention": 10, "softmax_decode": 200, "softmax_prefill": 10, "paged": 50,
         "norm": 100}
NORM_ROWS = (8, 128, 8448)  # a decode step's, a tick's and the forward's rows
CAP_PAGES = 8  # the capped chain-split rule: at most two 64-key tiles a range


def device_ms(fn, iters: int, only: str | None = None, tries: int = 3) -> float:
    """Device ms per call; ``only``: just the kernels whose name holds it.
    A trace that shows no device time (a process's first trace may miss its
    kernels) is taken again, up to ``tries`` times."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        if seen:
            return total / iters / 1e3
    raise RuntimeError("the profiler saw no device time")


def call_ms(fn, iters: int) -> float:
    """Wall ms per call between CUDA events: the host's launch cost where it
    exceeds the device's work."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def norm_inputs(rows: int, cols: int, seed: int = 0):
    """bf16 x and r, f32 gamma and beta, from one seed."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, r = (torch.randn(rows, cols, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(cols, generator=gen, device="cuda")
    return x, r, gamma, 0.1 * torch.randn(cols, generator=gen, device="cuda")


def norms(res: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels.gn_layernorm import ops as nm

    fused = hasattr(nm, "gn_add_rmsnorm")
    res["add_norm_fused"] = fused
    for rows in NORM_ROWS:
        x, r, gamma, beta = norm_inputs(rows, 2048)
        res[f"norm_rms_{rows}_ms"] = device_ms(lambda: nm.gn_rmsnorm(x, gamma), ITERS["norm"])
        res[f"norm_rms_{rows}_call_ms"] = call_ms(lambda: nm.gn_rmsnorm(x, gamma), ITERS["norm"])
        res[f"norm_ln_{rows}_ms"] = device_ms(lambda: nm.gn_layernorm(x, gamma, beta),
                                              ITERS["norm"])
        w = gamma.to(x.dtype)
        res[f"torch_rms_norm_{rows}_ms"] = device_ms(lambda: F.rms_norm(x, (2048,), w),
                                                     ITERS["norm"])
        if rows == NORM_ROWS[0]:
            continue
        add_norm = ((lambda: nm.gn_add_rmsnorm(x, r, gamma)) if fused
                    else (lambda: nm.gn_rmsnorm(x + r, gamma)))
        res[f"add_norm_{rows}_ms"] = device_ms(add_norm, ITERS["norm"])
        res[f"add_norm_{rows}_call_ms"] = call_ms(add_norm, ITERS["norm"])


def norm_layouts(root: str) -> list[dict]:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    from repro_torch.kernels.gn_layernorm import ops as nm

    out = []
    for cols, dtype, ln in ((2048, "bfloat16", False), (2048, "bfloat16", True),
                            (2048, "float32", False), (7168, "bfloat16", False)):
        for rows in (8, 128, 528, 1056, 2112, 4224, 8448, 16896):
            x, r, gamma, beta = norm_inputs(rows, cols)
            x, r = x.to(getattr(torch, dtype)), r.to(getattr(torch, dtype))
            beta = beta if ln else None
            y = torch.empty_like(x)
            line = {"root": root, "rows": rows, "cols": cols, "dtype": dtype,
                    "mode": "layernorm" if ln else "rms", "pick": nm.layout(x),
                    # the norm's bytes moved by a plain copy: the practical ceiling
                    "copy_ms": device_ms(lambda: y.copy_(x), ITERS["norm"])}
            chunks = -(-cols // (16 // x.element_size()))
            for name, g in nm.LAYOUTS.items():
                if g and chunks > 8 * g:  # the layout does not hold the row
                    continue
                line[f"{name}_ms"] = device_ms(
                    lambda: nm.gn_layernorm(x, gamma, beta, subtract_mean=ln, layout=name),
                    ITERS["norm"])
                line[f"{name}_fused_ms"] = device_ms(
                    lambda: nm.gn_add_layernorm(x, r, gamma, beta, subtract_mean=ln, layout=name),
                    ITERS["norm"])
            out.append(line)
            del x, r, y
    return out


def forward(root: str) -> list[dict]:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import time

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import make_model
    from repro_torch.serve.engine import perplexity

    model = make_model(get_config("internlm2-1.8b"))
    params = model.prepare(model.init(0, "cuda"), "cuda")
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, size=(8, 1056))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device="cuda")}
    perplexity(model, params, batch)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perplexity(model, params, batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        perplexity(model, params, batch)
        torch.cuda.synchronize()
    line = {"root": root, "host_ms": float(np.median(host)), "host_ms_all": host,
            "device_ms": 0.0, "norm_ms": 0.0, "norm_calls": 0, "add_ms": 0.0, "add_calls": 0}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        t = getattr(e, "self_device_time_total", None)
        ms = (t if t is not None else e.self_cuda_time_total) / 1e3
        line["device_ms"] += ms
        kind = ("norm" if "layernorm" in e.key or "norm_block" in e.key or "norm_warp" in e.key
                or "norm_stream" in e.key else "add" if "CUDAFunctor_add" in e.key else None)
        if kind:
            line[f"{kind}_ms"] += ms
            line[f"{kind}_calls"] += e.count
    return [line]


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
    norms(res)
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
    master = model.init(0, "cuda")
    reqs = seeded_requests(model.cfg.vocab, 16, 32, 1024, 32, 1, 0)
    out = []
    for cap in (None, CAP_PAGES, CAP_PAGES, None):
        # a new engine a turn: one that replays CUDA graphs keeps the chain
        # splits its captures saw, so each rule captures its own (warm run)
        pa.MAX_RANGE_PAGES = cap
        engine = ContinuousEngine(model, master, num_slots=8, max_seq=required_max_seq(reqs),
                                  chunk=16, block_size=16, device="cuda")
        engine.run(reqs)
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
        del engine
        torch.cuda.empty_cache()
    return out


def serve(root: str, arch: str = "internlm2-1.8b", kvs: tuple = ("fp", "int8"),
          static: bool = True) -> list[dict]:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import time

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import make_model
    from repro_torch.serve import engine as eng
    from repro_torch.serve.workload import required_max_seq, seeded_requests

    # as the launcher sets them: f32 matmuls in f32, bf16 ones summed in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    model = make_model(get_config(arch))
    master = model.init(0, "cuda")
    reqs = seeded_requests(model.cfg.vocab, 16, 32, 1024, 32, 1, 0)
    out = []
    for kv in kvs:
        engine = eng.ContinuousEngine(model, master, num_slots=8, max_seq=required_max_seq(reqs),
                                      chunk=16, block_size=16, kv_dtype=kv, device="cuda")
        line = {"root": root, "path": f"continuous_{kv}", "cold_seconds": timed(
            lambda: engine.run(reqs)), "seconds": [], "tokens_per_s": [], "mean_tick_ms": []}
        for _ in range(2):
            engine.reset()
            sec = timed(lambda: engine.run(reqs))
            line["seconds"].append(sec)
            line["tokens_per_s"].append(engine.generated_tokens / sec)
            line["mean_tick_ms"].append(float(np.mean([dt * 1e3 for *_, dt in engine.tick_log])))
        m = engine.metrics()
        line.update(ticks=m["model_ticks"], graphed=getattr(engine, "_graphs", None) is not None,
                    captures=m.get("fused_step_compilations", 0) + m.get("decode_compilations", 0),
                    capture_seconds=m.get("capture_seconds"))
        out.append(line)
        del engine
        torch.cuda.empty_cache()
    if not static:
        return out
    params = model.prepare(master, "cuda")
    del master
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, model.cfg.vocab, size=(8, 1024)),
                             dtype=torch.int32, device="cuda")
    cfg = eng.ServeConfig(max_new_tokens=32)
    timed(lambda: eng.generate(model, params, {"tokens": tokens}, cfg))
    gen_s = [timed(lambda: eng.generate(model, params, {"tokens": tokens}, cfg)) for _ in range(2)]
    logits, cache = model.prefill(params, {"tokens": tokens}, 1056)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    graphed = hasattr(eng, "static_decoder")
    if graphed:
        decode = eng.static_decoder(model, params, 8, 1056, torch.device("cuda"))
        model.prefill(params, {"tokens": tokens}, 1056, cache=decode.cache)
        step = lambda i: decode(nxt, 1024 + i)  # noqa: E731
    else:
        step = lambda i: model.decode_step(params, cache, nxt, 1024 + i)  # noqa: E731
    step_ms = [timed(lambda: step(i)) * 1e3 for i in range(17)][1:]
    out.append({"root": root, "path": "static", "generate_seconds": gen_s,
                "tokens_per_s": [8 * 32 / t for t in gen_s], "graphed": graphed,
                "decode_ms": float(np.median(step_ms)), "decode_ms_all": step_ms})
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])))
        return 0
    modes = {"--ticks": ticks, "--norm-layouts": norm_layouts, "--forward": forward,
             "--serve-one": serve,
             "--mla-one": lambda root: serve(root, "minicpm3-4b", ("fp",), static=False)}
    if len(argv) == 2 and argv[0] in modes:
        for line in modes[argv[0]](argv[1]):
            print(json.dumps(line))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    mode = "--one"
    if argv[0] in ("--serve", "--mla"):
        mode, argv = f"{argv[0]}-one", argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    for root in argv:
        out = subprocess.run([sys.executable, __file__, mode, root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        lines = out.stdout.strip().splitlines()
        print("\n".join(lines[-1:] if mode == "--one" else
                        [ln for ln in lines if ln.startswith("{")]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
