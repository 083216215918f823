#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases, each fatal on failure (exit code 1):
  1. build   - build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc
               (one process per source, in parallel); print the build time,
               the ptxas report and the card's name and power limit;
  2. kernels - each kernel against its plain PyTorch version on the card at
               its path's shapes, with stated tolerances, plus the exact-score
               and exact-ones checks (V = 1 => every valid output row is 1),
               the softmax's Σp = 1 and masked-zero checks, and device times
               beside the byte/flop bound and a library call's time;
  3. parity  - full-width internlm2-1.8b cut to 2 layers, kernels on the card
               against plain versions on the CPU, same weights, at float32
               and at bfloat16: one fused paged tick with mixed
               prefill/decode/parked lanes, and the static path's prefill,
               four decode steps and teacher-forced forward;
  4. serve   - the continuous path: full-width internlm2-1.8b (24 layers,
               random weights from a seed) through ``repro_torch.launch.serve
               --continuous``: 8 slots, chunk 16, block 16, 16 requests of
               32..1024 prompt tokens, 32 new tokens each, one arrival per
               tick; launch counts, drain, reset-replay, and the static
               oracle's token identity (reported, not gated);
  5. static  - the static path: the same model through the launcher's default
               mode, 2 batches of 8 x 1024-token prompts, 32 new tokens each,
               and the perplexity of each whole sequence; exact launch counts,
               finite logits and perplexity, a rerun of batch 0 token for
               token, prefill and decode-step times.
Each path's launch counters are set to 0 just before it runs and read just
after.  The last two lines are the kernels JSON and {"ok": true, ...}.

Usage: python3 chip_smoke.py   (needs one CUDA GPU and nvcc)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.luts import SoftmaxLUTConfig  # noqa: E402
from repro_torch.data.synthetic import optimal_perplexity  # noqa: E402
from repro_torch.kernels import _build, counters  # noqa: E402
from repro_torch.kernels.gn_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.gn_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.gn_layernorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.gn_layernorm import ref as norm_ref  # noqa: E402
from repro_torch.kernels.gn_paged_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.gn_paged_attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.gn_softmax import ops as sm_ops  # noqa: E402
from repro_torch.kernels.gn_softmax import ref as sm_ref  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models.transformer import make_model  # noqa: E402
from repro_torch.serve.engine import ServeConfig, generate  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the op rate per
# input type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEV = "cuda"
ARCH = "internlm2-1.8b"
SLOTS, CHUNK, BLOCK = 8, 16, 16
# the static path: batches of BATCH prompts of PROMPT tokens, NEW new tokens;
# its forward scores BATCH sequences of PROMPT + NEW tokens
BATCHES, BATCH, PROMPT, NEW = 2, 8, 1024, 32
# kernel-vs-plain tolerances on the card
NORM_ATOL_F32 = 4e-6      # sum order and mean vs sum*(1/C): a few f32 ulps at |y| ~ 4
ATTN_ATOL_F32 = 2e-4      # the reference's own kernel-vs-ref tolerance (online vs one-pass)
EXACT_ATOL = 2e-5         # exact grid scores: the Q1.15 rounding of the corrections alone
# random scores: rows that a Δ-grid flip or a coarse Q1.15 correction (a
# running max that jumps several logits) may take past ATTN_ATOL_F32
FLIP_ROWS = 0.01
BF16_REL = 2.0 ** -7      # bf16 outputs: one bf16 rounding of either side
ONES_ATOL = 1e-5          # V = 1: sum of p to one rounding
SM_ATOL_F32 = 1e-6        # GN softmax: the reference's own kernel-vs-ref tolerance
SUM_ATOL = 2e-6           # GN softmax: |Σp - 1| at f32 (the reference's invariant test)
SM_OPS_PER_ELEM = 8       # max, Δ, grid scale, round, LUT product, round, sum, scale
# model logits at |logit| <= ~4.4, kernels on the card vs plain on the CPU, same
# weights.  f32: the paged read's online LUT'd corrections and Δ flips on the
# first tokens' short rows; phase 3 also prints the gap with the plain read
# swapped in on the card, which isolates that share.  bf16: the activations
# round at other places in cuBLAS than on the CPU.
LOGITS_ATOL_F32 = 1e-2
LOGITS_ATOL_BF16 = 0.1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Wall time per call between CUDA events: the host's launch cost where
    it exceeds the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(prof) -> dict:
    """Device time (us) per kernel name in a torch.profiler trace."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            out[e.key] = t if t is not None else e.self_cuda_time_total
    return out


def device_ms(fn, iters: int) -> float:
    """Device time per call: the CUDA kernels the calls ran, summed from a
    torch.profiler (CUPTI) trace; falls back to call_ms when the trace
    shows no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(prof).values())
    return total / iters / 1e3 if total > 0 else call_ms(fn, iters)


def timings(fn, plain, library, iters: int) -> dict:
    return {"ms": device_ms(fn, iters), "call_ms": call_ms(fn, iters),
            "plain_ms": device_ms(plain, max(iters // 4, 3)),
            "library_ms": None if library is None else device_ms(library, iters)}


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for ``dtype``, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, atol: float, rel: float = 0.0) -> dict:
    """Max |got - want|, and the rows (last dim) with an element past
    atol + rel*|want|; the worst element relative to its bound beside them."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = err - (atol + rel * want.abs())
    i = int(excess.argmax())
    bad_rows = int((excess > 0).reshape(-1, got.shape[-1]).any(-1).sum())
    return {"max_abs_err": err.max().item(), "bad_rows": bad_rows,
            "rows": got.numel() // got.shape[-1],
            "worst": [got.flatten()[i].item(), want.flatten()[i].item()]}


# ------------------------------------------------------------------ phase 1 --
def phase_build() -> str:
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] kernels {sorted(_build._libs)} ready in {time.perf_counter() - t0:.2f}s "
          f"(nvcc wall {_build.build_seconds}s)")
    for name, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"[card] {card}")
    return card


# ------------------------------------------------------------------ phase 2 --
def norm_case(rows: int, dtype, gen) -> dict:
    x = torch.randn(rows, 2048, generator=gen, device=DEV).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(2048, generator=gen, device=DEV)
    got = norm_ops.gn_rmsnorm(x, gamma)
    want = norm_ref.gn_layernorm_ref(x, gamma, None, subtract_mean=False)
    check = compare(got, want, *((NORM_ATOL_F32, 0.0) if dtype == torch.float32
                                 else (1e-6, BF16_REL)))
    check["ok"] = check["bad_rows"] == 0
    nbytes = 2 * rows * 2048 * x.element_size() + 2048 * 4
    b_ms, b_by = bound(nbytes, 5 * rows * 2048, dtype)
    lib_w = gamma.to(dtype)
    return {
        "name": "gn_rmsnorm", "shape": [rows, 2048], "dtype": str(dtype).split(".")[-1],
        **check, "bound_ms": b_ms, "bound_by": b_by,
        **timings(lambda: norm_ops.gn_rmsnorm(x, gamma),
                  lambda: norm_ref.gn_layernorm_ref(x, gamma, None, subtract_mean=False),
                  lambda: torch.nn.functional.rms_norm(x, (2048,), lib_w), 100),
    }


def attn_inputs(c: int, dtype, gen, v_ones: bool = False, exact: bool = False):
    """N=8 sequences at serving widths (H16/Hkv8/D128, block 16): lengths up to
    1056, shuffled tables with stale ids past each length, one empty row.
    ``exact``: q and k in {-1, 0, 1}, q nonzero on 8 head dims only, under a
    scale of 1/8: every score is exact in f32 whatever the summation order,
    lies on the Δ grid and within one logit unit, so no score can flip a Δ
    rounding and every online correction is a fine Q1.15 factor."""
    n, h, hkv, d, bs, max_bt = SLOTS, 16, 8, 128, BLOCK, 66
    rng = np.random.default_rng(c)
    lengths = rng.integers(1, max_bt * bs + 1, size=n)
    lengths[3] = 0  # an empty sequence reads nothing
    n_valid = np.where(lengths > 0, np.minimum(rng.integers(1, c + 1, size=n), lengths), 0)
    starts = lengths - n_valid
    need = [-(-int(L) // bs) for L in lengths]
    nb = sum(need) + 8
    perm = rng.permutation(nb)
    tables = rng.integers(0, nb, size=(n, max_bt))  # stale entries everywhere ...
    o = 0
    for i, k in enumerate(need):                    # ... live chains in front
        tables[i, :k] = perm[o:o + k]
        o += k

    def draw(*shape):
        if exact:
            return torch.randint(-1, 2, shape, generator=gen, device=DEV).to(dtype)
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    q, k_ar = draw(n, c, h, d), draw(nb, bs, hkv, d)
    if exact:
        q[..., 8:] = 0
    v_ar = (torch.ones(nb, bs, hkv, d, device=DEV) if v_ones
            else torch.randn(nb, bs, hkv, d, generator=gen, device=DEV)).to(dtype)
    ints = [torch.as_tensor(a, dtype=torch.int32).to(DEV) for a in (tables, starts, n_valid)]
    return (q, k_ar, v_ar, *ints), lengths, n_valid


def attn_case(c: int, dtype, gen) -> dict:
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    args, lengths, n_valid = attn_inputs(c, dtype, gen)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    got = attn_ops.gn_paged_attention_chunk(*args)
    check = compare(got[lane], attn_ref.gn_paged_attention_chunk_ref(*args)[lane],
                    ATTN_ATOL_F32, rel)
    # scores exact, on the Δ grid and one logit wide: no flip is possible,
    # so every row must agree to the Q1.15 rounding of the corrections alone
    ex_args, _, _ = attn_inputs(c, dtype, gen, exact=True)
    exact = compare(attn_ops.gn_paged_attention_chunk(*ex_args, sm_scale=1 / 8)[lane],
                    attn_ref.gn_paged_attention_chunk_ref(*ex_args, sm_scale=1 / 8)[lane],
                    EXACT_ATOL, rel)
    # exact-ones: V = 1 turns each valid row into sum(p) = 1
    ones_args, _, _ = attn_inputs(c, torch.float32, gen, v_ones=True)
    ones_err = (attn_ops.gn_paged_attention_chunk(*ones_args)[lane] - 1.0).abs().max().item()
    empty_read = got[3].abs().max().item()  # the empty sequence must read nothing
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL and empty_read == 0.0)
    q = args[0]
    n, _, h, d = q.shape
    hkv, item, bs = args[1].shape[2], q.element_size(), BLOCK
    blocks = sum(-(-int(L) // bs) for L in lengths)
    nbytes = (2 * blocks * bs * hkv * d * item + 2 * q.numel() * item
              + 4 * (args[3].numel() + 2 * n))
    seen = sum(min(int(L) - int(nv) + i + 1, int(L)) for L, nv in zip(lengths, n_valid)
               for i in range(int(nv)))  # visible columns over the valid rows
    b_ms, b_by = bound(nbytes, 4 * h * d * seen, dtype)
    return {
        "name": "gn_paged_attention",
        "shape": {"N": n, "C": c, "H": h, "Hkv": hkv, "D": d, "block": bs,
                  "max_len": int(lengths.max())},
        "dtype": str(dtype).split(".")[-1], **check,
        "exact_scores": {k: exact[k] for k in ("max_abs_err", "bad_rows")},
        "ones_err": ones_err, "empty_read": empty_read, "bound_ms": b_ms, "bound_by": b_by,
        **timings(lambda: attn_ops.gn_paged_attention_chunk(*args),
                  lambda: attn_ref.gn_paged_attention_chunk_ref(*args), None, 20),
    }


def softmax_rows(rows: int, cols: int, dtype, gen, visible=None, scale: float = 3.0):
    """Random logits with columns past ``visible(row)`` masked at -1e30, as
    the model's score rows are; returns (x, mask of the masked entries)."""
    x = torch.randn(rows, cols, generator=gen, device=DEV) * scale
    masked = None
    if visible is not None:
        col = torch.arange(cols, device=DEV)[None]
        masked = col > visible(torch.arange(rows, device=DEV))[:, None]
        x = x.masked_fill_(masked, -1e30)
    return x.to(dtype), masked


def softmax_case(label: str, x, masked, cfg=None, iters: int = 0) -> dict:
    cfg = cfg or SoftmaxLUTConfig(frac_bits=3)
    got = sm_ops.gn_softmax(x, cfg)
    want = sm_ref.gn_softmax_ref(x, cfg)
    f32 = x.dtype == torch.float32
    check = compare(got, want, SM_ATOL_F32, 0.0 if f32 else BF16_REL)
    sum_err = (got.double().sum(-1) - 1).abs().max().item() if f32 else None
    masked_max = got[masked].abs().max().item() if masked is not None and masked.any() else 0.0
    check["ok"] = (check["bad_rows"] == 0 and masked_max == 0.0
                   and (sum_err is None or sum_err <= SUM_ATOL))
    res = {"name": "gn_softmax", "case": label, "shape": list(x.shape),
           "dtype": str(x.dtype).split(".")[-1],
           "lut": [cfg.frac_bits, cfg.delta_scale], **check, "sum_err": sum_err,
           "masked_max": masked_max}
    if iters:  # one read and one write of every element; elementwise ops on the CUDA cores
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), SM_OPS_PER_ELEM * x.numel(),
                           torch.float32)
        res.update(bound_ms=b_ms, bound_by=b_by, **timings(
            lambda: sm_ops.gn_softmax(x, cfg), lambda: sm_ref.gn_softmax_ref(x, cfg),
            lambda: torch.softmax(x, dim=-1), iters))
    return res


def softmax_cases(gen) -> list[dict]:
    """The prefill's causally masked score rows (B·H·S, S) and a decode
    step's (B·H, max_seq) with the tail past pos masked, both f32 as the
    model casts its scores; a bf16 case, a ragged case, a vocab-wide row
    set (the wide-row path) and the reference's three LUT configs."""
    out = []
    x, masked = softmax_rows(BATCH * 16 * PROMPT, PROMPT, torch.float32, gen,
                             visible=lambda r: r % PROMPT)
    out.append(softmax_case("prefill", x, masked, iters=10))
    del x, masked
    pos = PROMPT + NEW // 2
    x, masked = softmax_rows(BATCH * 16, PROMPT + NEW, torch.float32, gen,
                             visible=lambda r: torch.full_like(r, pos))
    out.append(softmax_case("decode", x, masked, iters=50))
    x, masked = softmax_rows(4096, PROMPT, torch.bfloat16, gen, visible=lambda r: r % PROMPT)
    out.append(softmax_case("bf16", x, masked))
    x, masked = softmax_rows(1000, 777, torch.float32, gen, visible=lambda r: (r * 7) % 777)
    out.append(softmax_case("ragged", x, masked))
    x, _ = softmax_rows(16, 92544, torch.float32, gen, scale=8.0)
    out.append(softmax_case("vocab", x, None))
    for frac_bits, delta_scale in ((0, 1.0), (3, 1.0), (4, 0.5)):
        x, masked = softmax_rows(4096, 200, torch.float32, gen, visible=lambda r: r % 200,
                                 scale=8.0)
        out.append(softmax_case(f"lut{frac_bits}", x, masked,
                                SoftmaxLUTConfig(frac_bits, delta_scale=delta_scale)))
    return out


def fa_inputs(shape, dtype, gen, exact: bool = False, v_ones: bool = False):
    """q (B, H, Sq, D), k and v (B, Hkv, Sk, D); ``exact``: q and k in
    {-1, 0, 1}, q nonzero on 8 head dims, for a scale of 1/8 (see
    attn_inputs)."""
    b, h, hkv, sq, sk, d = shape

    def draw(*s):
        if exact:
            return torch.randint(-1, 2, s, generator=gen, device=DEV).float()
        return torch.randn(*s, generator=gen, device=DEV)

    q, k = draw(b, h, sq, d), draw(b, hkv, sk, d)
    if exact:
        q[..., 8:] = 0
    v = torch.ones(b, hkv, sk, d, device=DEV) if v_ones else torch.randn(
        b, hkv, sk, d, generator=gen, device=DEV)
    return [t.to(dtype) for t in (q, k, v)]


def fa_case(label: str, shape, dtype, causal: bool, gen, iters: int = 0) -> dict:
    b, h, hkv, sq, sk, d = shape
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    q, k, v = fa_inputs(shape, dtype, gen)
    check = compare(fa_ops.gn_attention(q, k, v, causal=causal),
                    fa_ref.gn_attention_ref(q, k, v, causal=causal), ATTN_ATOL_F32, rel)
    eq, ek, ev = fa_inputs(shape, dtype, gen, exact=True)
    exact = compare(fa_ops.gn_attention(eq, ek, ev, causal=causal, sm_scale=1 / 8),
                    fa_ref.gn_attention_ref(eq, ek, ev, causal=causal, sm_scale=1 / 8),
                    EXACT_ATOL, rel)
    del eq, ek, ev
    oq, ok_, ov = fa_inputs(shape, torch.float32, gen, v_ones=True)
    ones_err = (fa_ops.gn_attention(oq, ok_, ov, causal=causal) - 1.0).abs().max().item()
    del oq, ok_, ov
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL)
    res = {"name": "gn_attention", "case": label,
           "shape": {"B": b, "H": h, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d, "causal": causal},
           "dtype": str(dtype).split(".")[-1], **check,
           "exact_scores": {key: exact[key] for key in ("max_abs_err", "bad_rows")},
           "ones_err": ones_err}
    if iters:
        # visible (row, column) pairs: row i sees min(Sk, i + Sk - Sq + 1) columns
        seen = (sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq)) if causal
                else sq * sk)
        item = q.element_size()
        b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * item,
                           4 * b * h * d * seen, dtype)
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                is_causal=causal and sq == sk, enable_gqa=True)
        res.update(bound_ms=b_ms, bound_by=b_by, **timings(
            lambda: fa_ops.gn_attention(q, k, v, causal=causal),
            lambda: fa_ref.gn_attention_ref(q, k, v, causal=causal), lib, iters))
    return res


def attention_cases(gen) -> list[dict]:
    """The forward's shape (B 8, H 16, Hkv 8, S = prompt + new, D 128,
    causal) in bf16 and f32, a non-causal case, a KV-prefix case (Sk > Sq,
    the causal offset) and a ragged S."""
    fwd = (BATCH, 16, 8, PROMPT + NEW, PROMPT + NEW, 128)
    return [fa_case("forward", fwd, torch.bfloat16, True, gen, iters=10),
            fa_case("forward", fwd, torch.float32, True, gen, iters=5),
            fa_case("non-causal", (2, 16, 8, 256, 256, 128), torch.bfloat16, False, gen),
            fa_case("kv-prefix", (1, 8, 1, 64, 256, 32), torch.float32, True, gen),
            fa_case("ragged", (2, 16, 8, 333, 333, 128), torch.float32, True, gen)]


def phase_kernels() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    norms = [norm_case(rows, dt, gen) for rows in (SLOTS * CHUNK, SLOTS)
             for dt in (torch.bfloat16, torch.float32)]
    attns = [attn_case(c, dt, gen) for c in (CHUNK, 1) for dt in (torch.bfloat16, torch.float32)]
    softmaxes = softmax_cases(gen)
    flashes = attention_cases(gen)
    results = norms + attns + softmaxes + flashes
    for r in results:
        print(f"[kernels] {json.dumps(r)}")
    bad = [f"{r['name']} {r.get('case', '')} {r['dtype']} {r['shape']}" for r in results
           if not r["ok"]]
    if bad:
        fail(f"kernel vs plain out of tolerance: {bad}")
    return {"gn_rmsnorm": norms, "gn_paged_attention": attns, "gn_softmax": softmaxes,
            "gn_attention": flashes}


# ------------------------------------------------------------------ phase 3 --
def tick_parity(base, master) -> dict:
    """One fused tick: slot 0 prefills 16 tokens from 0, slot 1 decodes at 100,
    slot 2 prefills 7 tokens at 48, slot 3 is parked.  The tick also runs on
    the card with the plain paged read swapped in, which splits the gap
    into the read's share and the rest's (matmuls, norm kernel)."""
    rng = np.random.default_rng(1)
    positions = np.array([0, 100, 48, 0], np.int32)
    n_valid = np.array([16, 1, 7, 0], np.int32)
    tokens = rng.integers(0, base.vocab, size=(4, 16)).astype(np.int32)
    tables = rng.permutation(48)[:32].reshape(4, 8).astype(np.int32)

    def tick(model, dev):
        params = model.prepare(master, dev)
        cache = model.init_paged_cache(48, BLOCK, dev)
        g = torch.Generator().manual_seed(2)  # prior context: random arena contents
        for key in ("k", "v"):
            cache[key].copy_(torch.randn(cache[key].shape, generator=g).to(cache[key].dtype))
        t = [torch.as_tensor(a).to(dev) for a in (tokens, positions, n_valid, tables)]
        return model.fused_step_slots_paged(params, cache, *t).float().cpu()

    errs = {}
    for dt, tol in (("float32", LOGITS_ATOL_F32), ("bfloat16", LOGITS_ATOL_BF16)):
        model = make_model(dataclasses.replace(base, dtype=dt))
        cpu = tick(model, "cpu")
        err = (tick(model, DEV) - cpu).abs().max().item()
        with swapped("gn_paged_attention_chunk", attn_ref.gn_paged_attention_chunk_ref):
            plain_read_err = (tick(model, DEV) - cpu).abs().max().item()
        print(f"[parity] {ARCH} 2 layers {dt} fused tick: max |logit diff| {err:.3e} "
              f"(plain paged read on the card: {plain_read_err:.3e}; "
              f"max |logit| {cpu.abs().max().item():.3f}, bound {tol})")
        errs[dt] = err
    return errs


class swapped:
    """Swap a kernel wrapper in ``models.attention`` for its plain version."""

    def __init__(self, name: str, plain):
        self.name, self.plain = name, plain

    def __enter__(self):
        self.kernel = getattr(attention_mod, self.name)
        setattr(attention_mod, self.name, self.plain)

    def __exit__(self, *exc):
        setattr(attention_mod, self.name, self.kernel)


def static_parity(base, master) -> dict:
    """The static path on 2 prompts of 16 tokens (the fused tick's chunk):
    prefill's logits, 4 decode steps' logits (both sides fed the CPU run's
    greedy tokens) and the teacher-forced forward's logits.  On the card it
    runs again with each new kernel's plain version swapped in, which
    isolates that kernel's share of the gap (the softmax runs in prefill
    and decode, the flash attention in the forward).  The bf16 gap is
    cuBLAS-vs-CPU rounding of the activations and grows with the number of
    logits compared: at 2 x 48 tokens it measured 0.1016 on an H100 with
    the kernels and with the plain versions alike (see PERF.md)."""
    steps = 4
    tokens = np.random.default_rng(3).integers(0, base.vocab, size=(2, 16)).astype(np.int32)
    s = tokens.shape[1]

    def run(model, dev, feed=None):
        params = model.prepare(master, dev)
        tok = torch.as_tensor(tokens).to(dev)
        logits, cache = model.prefill(params, {"tokens": tok}, s + steps)
        outs, fed = [logits.float().cpu()], []
        for i in range(steps):
            nxt = (feed[i] if feed is not None
                   else outs[-1][:, -1].argmax(-1).to(torch.int32)[:, None])
            fed.append(nxt)
            step_logits, cache = model.decode_step(params, cache, nxt.to(dev), s + i)
            outs.append(step_logits.float().cpu())
        return {"prefill": outs[0], "decode": torch.cat(outs[1:], 1),
                "forward": model.forward(params, {"tokens": tok}).float().cpu()}, fed

    def gaps(a, b):
        return {key: (a[key] - b[key]).abs().max().item() for key in a}

    errs = {}
    for dt, tol in (("float32", LOGITS_ATOL_F32), ("bfloat16", LOGITS_ATOL_BF16)):
        model = make_model(dataclasses.replace(base, dtype=dt))
        cpu, fed = run(model, "cpu")
        gap = gaps(run(model, DEV, fed)[0], cpu)
        with swapped("gn_softmax", sm_ref.gn_softmax_ref):
            plain_sm = gaps(run(model, DEV, fed)[0], cpu)
        with swapped("gn_attention", fa_ref.gn_attention_ref):
            plain_fa = gaps(run(model, DEV, fed)[0], cpu)
        print(f"[parity] {ARCH} 2 layers {dt} static path: max |logit diff| "
              f"{json.dumps(gap)} (plain softmax on the card: prefill "
              f"{plain_sm['prefill']:.3e}, decode {plain_sm['decode']:.3e}; plain flash "
              f"attention on the card: forward {plain_fa['forward']:.3e}; max |logit| "
              f"{max(v.abs().max().item() for v in cpu.values()):.3f}, bound {tol})")
        errs[dt] = max(gap.values())
    return errs


def phase_parity() -> dict:
    base = dataclasses.replace(get_config(ARCH), n_layers=2)
    master = make_model(base).init(seed=1, device=DEV)
    errs = {"tick": tick_parity(base, master), "static": static_parity(base, master)}
    for path, by_dtype in errs.items():
        for dt, tol in (("float32", LOGITS_ATOL_F32), ("bfloat16", LOGITS_ATOL_BF16)):
            if not math.isfinite(by_dtype[dt]) or by_dtype[dt] > tol:
                fail(f"model parity ({path}) at {dt}: {by_dtype[dt]:.3e} > {tol}")
    return errs


# ------------------------------------------------------------------ phase 4 --
def phase_serve() -> dict:
    counters.reset()
    out = serve_mod.main([
        "--arch", ARCH, "--continuous", "--seed", "0", "--num-slots", str(SLOTS),
        "--chunk", str(CHUNK), "--block-size", str(BLOCK), "--requests", "16",
        "--min-prompt", "32", "--max-prompt", "1024", "--new-tokens", "32", "--stagger", "1",
    ])
    launches = out["launches"]  # the engine's run; the static oracle's launches follow it
    plain_on_cuda = sum(counters.plain_cuda_calls().values())
    engine, reqs, comps = out["engine"], out["requests"], out["completions"]
    m = engine.metrics()
    ticks, layers = m["model_ticks"], engine.model.cfg.n_layers
    tick_ms = [dt * 1e3 for _, _, dt in engine.tick_log]
    if len(comps) != len(reqs) or any(len(c.new_tokens) != r.max_new_tokens for c, r in
                                       zip(sorted(comps, key=lambda c: c.request_id), reqs)):
        fail("not every request completed with its budget")
    if engine.pool.blocks_in_use or engine.pool.num_free != SLOTS:
        fail(f"blocks not returned: {engine.pool.blocks_in_use} in use")
    if launches["gn_paged_attention"] != layers * ticks:
        fail(f"paged attention launches {launches} != {layers} x {ticks} ticks")
    if launches["gn_rmsnorm"] != (2 * layers + 1) * ticks:
        fail(f"norm launches {launches} != {2 * layers + 1} x {ticks} ticks")
    if launches["gn_softmax"] or launches["gn_attention"]:
        fail(f"the paged tick launched a static-path kernel: {launches}")
    if plain_on_cuda:
        fail(f"{plain_on_cuda} plain-version calls on CUDA tensors in the serving run")
    if not bool(torch.isfinite(engine._last_logits).all()):
        fail("non-finite logits")
    first = {c.request_id: c.new_tokens for c in comps}
    # the replay runs under a CUDA-only profiler: device busy time and the
    # kernels that take it
    engine.reset()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = {c.request_id: c.new_tokens for c in engine.run(reqs)}
        torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    if any(not np.array_equal(first[i], again[i]) for i in first):
        fail("reset + rerun gave different tokens")
    per_kernel = _device_us(prof)
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[serve-profile] device busy {busy_s:.3f}s of {rerun_s:.3f}s "
          f"({100 * busy_s / rerun_s:.1f}%); top kernels (s): "
          + json.dumps({k[:60]: v / 1e6 for k, v in top}))
    res = {
        "requests": len(comps), "generated_tokens": m["generated_tokens"],
        "seconds": out["seconds"], "tokens_per_s": m["generated_tokens"] / out["seconds"],
        "model_ticks": ticks, "fused_ticks": m["fused_ticks"],
        "mean_tick_ms": float(np.mean(tick_ms)), "launches": launches,
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
        "profiled_rerun_seconds": rerun_s, "device_busy_seconds": busy_s,
        # online paged read vs one-pass static softmax: reported, not gated
        "static_identical": f"{out['static_identical']}/{len(comps)}",
        "mean_common_prefix": float(np.mean(out["common_prefix"])),
    }
    print(f"[serve] {json.dumps(res)}")
    return res


# ------------------------------------------------------------------ phase 5 --
def timed(fn):
    """(result, host ms) around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_static() -> dict:
    counters.reset()
    out = serve_mod.main(["--arch", ARCH, "--seed", "0", "--batches", str(BATCHES),
                          "--batch-size", str(BATCH), "--prompt-len", str(PROMPT),
                          "--new-tokens", str(NEW)])
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    model, params = out["model"], out["params"]
    layers = model.cfg.n_layers
    want = {"gn_rmsnorm": BATCHES * (2 * layers + 1) * (NEW + 2), "gn_paged_attention": 0,
            "gn_softmax": BATCHES * layers * (1 + NEW), "gn_attention": BATCHES * layers}
    if launches != want or out["launches"] != want:
        fail(f"static launches {launches} (run: {out['launches']}) != {want}")
    if any(plain.values()):
        fail(f"plain-version calls on CUDA tensors in the static run: {plain}")
    if not all(math.isfinite(p) for p in out["perplexities"]):
        fail(f"non-finite perplexity {out['perplexities']}")
    prompt = out["prompts"][0]
    # the rerun runs under a CUDA-only profiler: device busy time and the
    # kernels that take it
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = generate(model, params, {"tokens": prompt}, ServeConfig(max_new_tokens=NEW))
        torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    if not torch.equal(again, out["outputs"][0]):
        fail("a rerun of batch 0 gave different tokens")
    per_kernel = _device_us(prof)
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[static-profile] generate of batch 0: device busy {busy_s:.3f}s of {rerun_s:.3f}s "
          f"({100 * busy_s / rerun_s:.1f}%); top kernels (s): "
          + json.dumps({k[:60]: v / 1e6 for k, v in top}))
    (logits, cache), prefill_ms = timed(
        lambda: model.prefill(params, {"tokens": prompt}, PROMPT + NEW))
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite prefill logits")
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    del logits
    step_ms = []
    for i in range(min(8, NEW)):
        (step, cache), ms = timed(lambda: model.decode_step(params, cache, nxt, PROMPT + i))
        if not bool(torch.isfinite(step).all()):
            fail("non-finite decode logits")
        nxt = step[:, 0].argmax(-1).to(torch.int32)[:, None]
        step_ms.append(ms)
    res = {"batches": BATCHES, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "layers": layers, "generated_tokens": out["generated_tokens"],
           "seconds": out["seconds"], "tokens_per_s": out["generated_tokens"] / out["seconds"],
           "batch_seconds": out["batch_seconds"], "perplexities": out["perplexities"],
           "optimal_perplexity": optimal_perplexity(out["data"]),
           "prefill_ms": prefill_ms, "decode_ms_per_step": float(np.mean(step_ms[1:])),
           "profiled_rerun_seconds": rerun_s, "device_busy_seconds": busy_s,
           "launches": launches}
    print(f"[static] {json.dumps(res)}")
    return res


SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "gn_rmsnorm": ("src/repro_torch/csrc/gn_layernorm.cu",
                   "src/repro/kernels/gn_layernorm/kernel.py:81"),
    "gn_paged_attention": ("src/repro_torch/csrc/gn_paged_attention.cu",
                           "src/repro/kernels/gn_paged_attention/kernel.py:160"),
    "gn_softmax": ("src/repro_torch/csrc/gn_softmax.cu",
                   "src/repro/kernels/gn_softmax/kernel.py:59"),
    "gn_attention": ("src/repro_torch/csrc/gn_attention.cu",
                     "src/repro/kernels/gn_attention/kernel.py:140"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    card = phase_build()
    kern = phase_kernels()
    phase_parity()
    served = phase_serve()
    torch.cuda.empty_cache()
    static = phase_static()
    by_path = {"continuous": served["launches"], "static": static["launches"]}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        main_case = kern[name][0]  # the main path's shape: bf16 tick, f32 prefill rows, bf16 forward
        counts = {path: n[name] for path, n in by_path.items() if n[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(counts.values()), "launches_by_path": counts,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": main_case["shape"],
            "dtype": main_case["dtype"],
        })
    print(f"[total] {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
