#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Phases, each fatal on failure (exit code 1):
  1. build   - build every CUDA kernel from ``src/repro_torch/csrc`` with nvcc
               (one process per source, in parallel); print the build time,
               the ptxas report and the card's name and power limit;
  2. kernels - each kernel against its plain PyTorch version on the card at
               its path's shapes, with stated tolerances (the norm in RMS and
               LayerNorm mode at a tick's, a decode step's and the forward's
               rows, each case naming its layout, and its fused residual add
               held bit for bit to the eager add and the unfused kernel),
               plus the exact-score
               and exact-ones checks (V = 1 => every valid output row is 1),
               the softmax's Σp = 1 and masked-zero checks, and device times
               beside the byte/flop bound and a library call's time; the
               paged read in its fp mode and in its int8 mode (arenas
               quantized on the card by ``paged_quant_write``), bf16 on its
               tensor-core design and f32 on its CUDA-core design, and at the
               long phases' 514-column tables (65 chain ranges); the flash
               attention in bf16 (its tensor-core design, V = 1 drawn in
               bf16) and in f32 (its CUDA-core design), and at the long
               prefills' shapes (S = 4096 and 8192); the softmax at the long
               decode rows (4128 and 8224 columns), each timed case naming
               the layout it ran; each attention case names its design; the fp
               paged read's rows finite exactly where its plain version's are
               over a NaN or Inf K or V tile, and its per-row flags of a
               nonfinite live score equal to the plain version's; and
               (``[backward]``) the gradient of each differentiable kernel
               wrapper (kernel forward, plain backward) against plain
               autograd through its plain version with the straight-through
               Jacobian, at f32 at the training shapes cut to 2 q heads: the
               softmax, the norm (RMS, LayerNorm, fused add) and the flash
               attention in both designs (f32, bf16);
  3. parity  - full-width internlm2-1.8b cut to 2 layers, kernels on the card
               against plain versions on the CPU, same weights, at float32
               and at bfloat16: one fused paged tick with mixed
               prefill/decode/parked lanes over fp and over int8 arenas (at
               f32 also through the reference's streamed and gathered reads:
               streamed against gathered, the kernel read against streamed),
               and the static path's prefill, four decode steps and
               teacher-forced forward;
  4. serve   - the continuous path: full-width internlm2-1.8b (24 layers,
               random weights from a seed) through ``repro_torch.launch.serve
               --continuous``: 8 slots, chunk 16, block 16, 16 requests of
               32..1024 prompt tokens, 32 new tokens each, one arrival per
               tick; every tick a CUDA-graph replay, captured once per
               (step kind, horizon bucket) within the grid's bound; launch
               counts, drain, a timed reset-replay (launches gated again), a
               profiled one (device busy share, the GN kernels' device
               records against the launches; a trace that lost records is
               taken again), the eager tick on the same
               workload bit for bit against the graphed one (tokens, held
               logits, arenas), and the static oracle's token identity
               (reported, not gated);
  5. static  - the static path: the same model through the launcher's default
               mode, 2 batches of 8 x 1024-token prompts, 32 new tokens each,
               and the perplexity of each whole sequence; exact launch counts,
               one decode graph for both batches, finite logits and
               perplexity, a profiled rerun of batch 0 token for token (the
               GN kernels' device records against the launches), prefill
               time, the replayed decode step's time beside the eager step's
               (their logits bit for bit), and the time of batch 0's
               teacher-forced perplexity (the 24-layer forward through the
               flash attention) with its profiled top kernels;
  6. int8    - phase 4's workload and model through ``ContinuousEngine(
               kv_dtype="int8")``: int8 block-paged KV with per-block f32
               scales, the int8 write captured with the tick; phase 4's
               checks (int8-mode launches and no fp-mode launch, the
               scales bitwise against the eager tick too), the pool's bytes
               beside phase 4's fp pool, and each request's common greedy
               prefix with phase 4's fp tokens (reported, not gated: random
               weights give near-flat logits);
  7. long-static - prompts past 2048 tokens through ``generate``: 4 x 4096,
               then 2 x 8192 tokens, 32 new tokens each; exact launches (the
               flash kernel in prefill, the softmax in every decode step),
               prefill and replayed decode-step times, the softmax layout of
               the decode rows, the 4096 batch's perplexity, and phase 2's
               flash times at those shapes beside their bound and SDPA;
  8. long    - the continuous path over 8 seeded prompts of 2049..8192 tokens
               (8 slots, chunk 16, block 16, one arrival a tick): graphed,
               captures within the grid's bound, launches exact, drained; a
               timed rerun, a profiled window of ticks, and the static
               oracle's tokens (reported, not gated);
  9. reads   - phase 4's workload and weights through the reference's
               streamed read (fp and int8 pools) and gathered read (fp),
               forced by ``FORCE_PAGED_READ``, each graphed, with phase 4's
               checks (a profiled window of 64 ticks); their tok/s, tick and
               busy share beside phases 4 and 6, and the greedy prefix shared
               with phase 4 (not gated);
 10. guard   - sampling and the GN sentinels on the continuous path: the
               sampler's hash words on the card bitwise the CPU's and its
               device time at the tick's shape; phase 4's workload at
               temperature 0.7 with phase 4's checks (graphed tokens bitwise
               the eager tick's, a reset replay identical) and its tok/s and
               tick beside greedy; the sentinels' cost per tick (greedy runs
               with them on and off in turns, tokens equal); chaos runs over
               the fp and the int8 pool at full width (gated: every V-tile,
               scale and table fault flagged within one tick, its block
               quarantined, the ledger balanced after every tick, launches
               exact, every tick a replay, the run drained; the K-tile run
               gated alike since the paged read flags nonfinite scores;
               reported: the recovered tokens against the fault-free run's);
 11. train   - full-width, full-depth internlm2-1.8b trained: bf16 compute
               over f32 masters, TRAIN_STEPS AdamW steps of TRAIN_BATCH x
               TRAIN_SEQ tokens of one repeated batch in TRAIN_MB
               microbatches; launches exact (the norm and the flash kernel
               in every forward, the softmax in every flash backward), every
               loss and grad_norm finite, the loss falling every step; ms a
               step, tokens/s, peak memory, a profiled step's busy share, a
               microbatch's launches in forward and in backward;
 12. ckpt    - the same widths cut to 2 layers: 3 steps (Adam moments in
               bf16), save and restore (params, opt_state), every leaf
               bitwise, bytes and seconds of both; 8 requests served through
               ContinuousEngine from the restored (params,), sentinels
               silent; ``launch.train --smoke --steps 3`` and ``launch.serve
               --smoke --ckpt`` as subprocesses on the card;
 13. table1  - the Table I analogue: the tiny gpt-neo trained TABLE1_STEPS
               steps with exact ops, evaluated under exact, GN and the
               bit-accurate hwsim ops (the GN row through the kernels, its
               launches exact): perplexity, top-1, their changes in
               percent, the training's seconds;
 14. tables  - the paper's comparison path: (a) on phase 13's checkpoint
               (one temporary root for both), Table I's rows (the GN and
               hwsim rows gated within 0.1% perplexity of FP32), Table II,
               Fig. 5 (the GN rows' errors gated below their edges), the
               Fig. 2 sweep with the paged reads' Σp bound (gated) and
               Table III; (b) full-width gpt-neo-1.3b in bf16 (random
               weights) through ``perplexity`` over 4 x 1024 tokens under
               FP32, Table II's pairs and the hwsim pair: a forward's ms,
               peak memory and perplexity, GN kernels launched only in the
               (gn, gn_ln) row (gated); (c) layer 0's score rows and
               pre-norm rows at that width, 2048 of each through every
               softmax and norm name on the card and on the CPU (the
               hwsim bitwise, the rest within stated tolerances; gated),
               each name's ms over all the rows, the hwsim's loops' ms,
               and Fig. 5's fractions beside the tiny backbone's.
Phases 4-10 serve with the GN sentinels on, the engine's default: a tick
launches one more norm, the head's σ probe.
Each path's launch counters are set to 0 just before it runs and read just
after.  The last two lines are the kernels JSON and {"ok": true, ...}.

Usage: python3 chip_smoke.py   (needs one CUDA GPU and nvcc)
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis import tracekeys  # noqa: E402
from repro_torch.benchmarks import (fig5_norm_error, norm_error_study,  # noqa: E402
                                    table1_accuracy, table2_score_tasks, table3_hw_cost)
from repro_torch.benchmarks.common import tiny_cfg  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import baselines, get_norm, get_softmax  # noqa: E402
from repro_torch.core.fixedpoint import lod, shift_subtract_div  # noqa: E402
from repro_torch.core.gn_layernorm import newton_rsqrt  # noqa: E402
from repro_torch.core.luts import TPU_SOFTMAX_LUT, SoftmaxLUTConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig, batch_at, optimal_perplexity  # noqa: E402
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
from repro_torch.serve.engine import (ContinuousEngine, ServeConfig, generate,  # noqa: E402
                                      perplexity, static_decoder, static_reference)
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.sampling import counter_bits, sample  # noqa: E402
from repro_torch.serve.workload import required_max_seq, seeded_requests  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,  # noqa: E402
                                         tree_leaves, tree_map)

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and the op rate per
# input type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEV = "cuda"
ARCH = "internlm2-1.8b"
SLOTS, CHUNK, BLOCK = 8, 16, 16
# the continuous workload (phases 4 and 6): REQUESTS seeded prompts of
# MIN_PROMPT..MAX_PROMPT tokens, NEW new tokens each, one arrival per tick
REQUESTS, MIN_PROMPT, MAX_PROMPT, SEED = 16, 32, 1024, 0
# the static path: batches of BATCH prompts of PROMPT tokens, NEW new tokens;
# its forward scores BATCH sequences of PROMPT + NEW tokens
BATCHES, BATCH, PROMPT, NEW = 2, 8, 1024, 32
# the long phases: the static path's batches of (prompts, prompt tokens), NEW
# new tokens each; the continuous path's LONG_REQUESTS seeded prompts of
# LONG_MIN..LONG_MAX tokens, NEW new tokens each (SLOTS, CHUNK, BLOCK, one
# arrival a tick), whose tables reach LONG_BT columns
LONG_BATCHES = ((4, 4096), (2, 8192))
LONG_REQUESTS, LONG_MIN, LONG_MAX = 8, 2049, 8192
LONG_BT = -(-(LONG_MAX + NEW) // BLOCK)
LONG_WINDOW = 64  # ticks of the long continuous rerun (and phases 9, 10) that are profiled
# phase 10: the sampled run's temperature; the chaos runs inject a fault every
# CHAOS_EVERY model ticks, CHAOS_FAULTS in all, drawn in turn from each
# pool's kinds (V tiles on the fp pool; K tiles, flagged by the paged
# kernel's per-row flag of a nonfinite score, in a run of their own)
GUARD_T = 0.7
CHAOS_EVERY, CHAOS_FAULTS = 10, 9
CHAOS = {"fp": ("nan_tile", "inf_tile", "table"), "int8": ("scale", "table")}
# the training phases: TRAIN_BATCH sequences of TRAIN_SEQ tokens a step (one
# batch of batch_at, repeated), TRAIN_MB microbatches, TRAIN_STEPS steps;
# the Table I analogue trains TABLE1_STEPS steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS, TABLE1_STEPS = 4, 1024, 2, 4, 300
# gradients on the card, kernel forward + plain backward against plain
# autograd through the plain forward with the straight-through Jacobian,
# relative L2 per input: the softmax and the norm run the same plain
# backward on forwards that agree to f32 rounding; attention's backward
# takes the flash kernel's output o (online corrections, 2e-4; a Δ-grid
# flip on a few rows), and in bf16 o and the gradients round to bf16
GRAD_REL = {"softmax": 1e-5, "norm": 1e-5, "attention_float32": 1e-3,
            "attention_bfloat16": 3e-2}
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
# the streamed read against the gathered read on the card, f32 logits: bit for
# bit (cuBLAS reduced each score's dot alike for a tile and for the stream on
# an H100, PERF.md); a nonzero bound would state where it does not
STREAMED_ATOL = 0.0


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


RECORD_LOSS = 0.05  # share of a GN kernel's device records a trace may lose
TRACE_ATTEMPTS = 3  # traces of a rerun, taken until one holds the GN kernels' records
# the GN kernels' device names (the paged read's range merge apart), for
# counting their records in a profiled run, graph replays included
KERNEL_NAMES = {"gn_paged_attention": ("gn_paged_attention_kernel", "gn_paged_attention_tc_kernel"),
                "gn_rmsnorm": ("norm_block_kernel", "norm_warp_kernel", "norm_stream_kernel"),
                "gn_softmax": ("gn_softmax_warp_kernel", "gn_softmax_block_kernel",
                               "gn_softmax_row_kernel"),
                "gn_attention": ("gn_attention_kernel", "gn_attention_tc_kernel")}


def record_counts(prof) -> dict:
    """Device records per kernel name in a torch.profiler trace."""
    return {e.key: e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA")}


def traced_rerun(label: str, rerun, want: dict) -> tuple:
    """``rerun()`` -> (result, its CUDA-only trace, seconds), a profiled
    rerun that checks its own result, with the GN kernels' device records in
    its trace held against the launches the run executed (``want``): an
    independent check of the counters, which a graph replay ticks by what
    its capture counted.  A record count above the launches fails at once.
    CUPTI reports the kernels of replayed graphs but loses records of some
    traces: a few of ~12k in most (3 to 12 on an H100), and once 21% of
    them, every GN kernel alike and ending mid-tick, in a rerun whose tokens
    equalled the first run's.  A trace that lost more than RECORD_LOSS of a
    kernel's records also undercounts the busy time, so it is discarded and
    the rerun traced again, at most TRACE_ATTEMPTS times; the run fails if
    no trace holds.  That every captured kernel ran is shown exactly by the
    eager rerun (bitwise the graphed one) and the counters by the launch
    gates.  Returns (result, trace, seconds, records, traces taken)."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        out, prof, seconds = rerun()
        counts = record_counts(prof)
        got = dict.fromkeys(KERNEL_NAMES, 0)
        for key, n in counts.items():
            for name, devnames in KERNEL_NAMES.items():
                if any(d in key for d in devnames):
                    got[name] += n
        keys = {k[:90]: n for k, n in counts.items()
                if any(d in k for names in KERNEL_NAMES.values() for d in names)}
        if any(got[k] > want[k] for k in want):
            fail(f"{label}: device records of the GN kernels {got} above launches {want}: {keys}")
        if all(want[k] * (1 - RECORD_LOSS) <= got[k] for k in want):
            return out, prof, seconds, got, attempt
        print(f"[{label}-profile] trace {attempt} of {TRACE_ATTEMPTS} lost device records of "
              f"the GN kernels: {json.dumps(got)} against launches {json.dumps(want)}: "
              f"{json.dumps(keys)}")
    fail(f"{label}: every one of {TRACE_ATTEMPTS} traces lost more than {RECORD_LOSS:.0%} of a "
         f"GN kernel's device records (the last {got} against launches {want})")


def profiled(fn):
    """(fn's result, its CUDA-only torch.profiler trace, fn's wall seconds):
    a short kernel, a synchronize and 10 ms run first inside the trace, and
    10 ms after fn's work has ended, so that no launch of fn sits at an edge
    of the trace (a trace that started on a launch-bound path was seen to
    miss its first records)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=DEV).add_(1)
        torch.cuda.synchronize()
        time.sleep(0.01)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        time.sleep(0.01)
    return out, prof, seconds


def check_graphs(label: str, m: dict) -> None:
    """Every model tick a graph replay; one capture per (step kind, bucket)
    seen, within the bucket grid's bound (the reference's compile-count
    contract, from the port's copy of its trace keys)."""
    grid = m["horizon_bucket_grid"]
    space, seen = tracekeys.trace_key_space(paged=True, grid=grid), tracekeys.seen_trace_keys(m)
    counts = {"fused": m["fused_step_compilations"], "decode": m["decode_compilations"]}
    diff = tracekeys.format_trace_key_diff(space, seen, counts)
    bound = tracekeys.compile_bound(paged=True, grid=grid)
    if (not seen <= space
            or counts["fused"] != len(m["fused_buckets"])
            or counts["decode"] != len(m["decode_buckets"])
            or any(counts[k] > bound[k] for k in counts) or m["prefill_compilations"]):
        fail(f"{label}: captures off the trace-key contract\n{diff}")
    if m["transfer_guarded_ticks"] != m["model_ticks"]:
        fail(f"{label}: {m['model_ticks'] - m['transfer_guarded_ticks']} of "
             f"{m['model_ticks']} ticks were not graph replays")


def timed_run(engine, reqs) -> tuple[dict, float]:
    """A reset and a run of ``reqs``: (request id -> new tokens, seconds)."""
    engine.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = {c.request_id: c.new_tokens for c in engine.run(reqs)}
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def eager_against_graphed(label: str, engine, reqs, graphed: dict, state: dict) -> dict:
    """The workload once more with the engine's tick function called
    directly (no graph): its tokens, held logits and real arena blocks (and
    int8 scales) must equal the graphed run's bit for bit; returns its
    tick and tok/s."""
    graphs, engine._graphs = engine._graphs, None
    try:
        toks, seconds = timed_run(engine, reqs)
    finally:
        engine._graphs = graphs
    if any(not np.array_equal(toks[i], graphed[i]) for i in graphed):
        fail(f"{label}: the eager tick's tokens differ from the graphed tick's")
    nb = engine.pool.num_blocks
    now = {"last_logits": engine._last_logits,
           **{k: v[:, :nb] for k, v in engine.pool.cache.items()}}
    bad = [k for k, v in state.items() if not torch.equal(v, now[k])]
    if bad:
        fail(f"{label}: the eager tick's {bad} differ from the graphed tick's")
    return {"eager_seconds": seconds,
            "eager_tokens_per_s": engine.generated_tokens / seconds,
            "eager_mean_tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log]))}


def engine_state(engine) -> dict:
    """Clones of what a run leaves on the device: the held logits and the
    real blocks of the arenas (and scales); the write sink is never read."""
    nb = engine.pool.num_blocks
    return {"last_logits": engine._last_logits.clone(),
            **{k: v[:, :nb].clone() for k, v in engine.pool.cache.items()}}


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
def norm_tol(dtype) -> tuple[float, float]:
    return (NORM_ATOL_F32, 0.0) if dtype == torch.float32 else (1e-6, BF16_REL)


def norm_case(rows: int, dtype, gen, cols: int = 2048, subtract_mean: bool = False) -> dict:
    """The norm in RMS mode, or in LayerNorm mode with a beta, against its
    plain version; library: ``F.rms_norm`` or ``F.layer_norm`` (exact, not
    GN) with gamma and beta in x's dtype."""
    x = torch.randn(rows, cols, generator=gen, device=DEV).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(cols, generator=gen, device=DEV)
    beta = 0.1 * torch.randn(cols, generator=gen, device=DEV) if subtract_mean else None
    kw = {"subtract_mean": subtract_mean}
    check = compare(norm_ops.gn_layernorm(x, gamma, beta, **kw),
                    norm_ref.gn_layernorm_ref(x, gamma, beta, **kw), *norm_tol(dtype))
    check["ok"] = check["bad_rows"] == 0
    # x read and y written once, gamma (and beta) read once; f32 arithmetic
    # on the CUDA cores: 5 operations an element (RMS), 8 with the mean
    nbytes = 2 * x.numel() * x.element_size() + cols * 4 * (1 + subtract_mean)
    b_ms, b_by = bound(nbytes, (8 if subtract_mean else 5) * x.numel(), torch.float32)
    lib_w, lib_b = gamma.to(dtype), None if beta is None else beta.to(dtype)
    library = (functools.partial(F.layer_norm, x, (cols,), lib_w, lib_b) if subtract_mean
               else functools.partial(F.rms_norm, x, (cols,), lib_w))
    return {
        "name": "gn_rmsnorm", "mode": "layernorm" if subtract_mean else "rms",
        "layout": norm_ops.layout(x), "shape": [rows, cols], "dtype": str(dtype).split(".")[-1],
        **check, "bound_ms": b_ms, "bound_by": b_by,
        "library": "F.layer_norm" if subtract_mean else "F.rms_norm",
        **timings(lambda: norm_ops.gn_layernorm(x, gamma, beta, **kw),
                  lambda: norm_ref.gn_layernorm_ref(x, gamma, beta, **kw), library, 100),
    }


def fused_norm_case(rows: int, dtype, gen, cols: int = 2048) -> dict:
    """The fused add + RMS norm: s bit for bit the eager x + r, y bit for bit
    the unfused kernel on s and within the norm's tolerance of the plain
    version.  library_ms is two calls (the eager add, then F.rms_norm);
    unfused_ms the eager add and the unfused kernel, the path it replaces."""
    x = torch.randn(rows, cols, generator=gen, device=DEV).to(dtype)
    r = torch.randn(rows, cols, generator=gen, device=DEV).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(cols, generator=gen, device=DEV)
    s, y = norm_ops.gn_add_rmsnorm(x, r, gamma)
    s_exact = torch.equal(s, x + r)
    y_exact = torch.equal(y, norm_ops.gn_rmsnorm(s, gamma))
    check = compare(y, norm_ref.gn_add_layernorm_ref(x, r, gamma, None, subtract_mean=False)[1],
                    *norm_tol(dtype))
    check["ok"] = check["bad_rows"] == 0 and s_exact and y_exact
    # x and r read, s and y written once, gamma read once
    b_ms, b_by = bound(4 * x.numel() * x.element_size() + cols * 4, 6 * x.numel(),
                       torch.float32)
    lib_w = gamma.to(dtype)
    return {
        "name": "gn_rmsnorm_fused", "mode": "rms", "layout": norm_ops.layout(x, r),
        "shape": [rows, cols], "dtype": str(dtype).split(".")[-1], **check,
        "s_bitwise": s_exact, "y_bitwise_unfused": y_exact, "bound_ms": b_ms, "bound_by": b_by,
        "library": "x + r, then F.rms_norm (two calls)",
        **timings(lambda: norm_ops.gn_add_rmsnorm(x, r, gamma),
                  lambda: norm_ref.gn_add_layernorm_ref(x, r, gamma, None, subtract_mean=False),
                  lambda: F.rms_norm(x + r, (cols,), lib_w), 100),
        "unfused_ms": device_ms(lambda: norm_ops.gn_rmsnorm(x + r, gamma), 100),
        "unfused_call_ms": call_ms(lambda: norm_ops.gn_rmsnorm(x + r, gamma), 100),
    }


def norm_cases(gen) -> tuple[list[dict], list[dict]]:
    """A tick's rows (SLOTS x CHUNK = 128), a decode step's (8) and the
    forward's (8448 = 8 x 1056) at d_model 2048, RMS (the model's mode) and
    LayerNorm with a beta; f32 at the few-row shapes; deepseek-coder-33b's
    width 7168 at the forward's rows; the fused add + norm at 128 and 8448
    rows."""
    rows = (SLOTS * CHUNK, SLOTS, BATCH * (PROMPT + NEW))
    norms = [norm_case(n, torch.bfloat16, gen) for n in rows]
    norms += [norm_case(n, torch.float32, gen) for n in rows[:2]]
    norms += [norm_case(n, torch.bfloat16, gen, subtract_mean=True) for n in rows]
    norms += [norm_case(SLOTS * CHUNK, torch.float32, gen, subtract_mean=True),
              norm_case(rows[2], torch.bfloat16, gen, cols=7168)]
    fused = [fused_norm_case(n, torch.bfloat16, gen) for n in (rows[0], rows[2])]
    return norms, fused


def attn_inputs(c: int, dtype, gen, v_ones: bool = False, exact: bool = False,
                max_bt: int = 66):
    """N=8 sequences at serving widths (H16/Hkv8/D128, block 16): lengths up to
    ``max_bt`` blocks (66: 1056 tokens, phase 4's; LONG_BT: 8224, the long
    phases'), shuffled tables with stale ids past each length, one empty row.
    ``exact``: q and k in {-1, 0, 1}, q nonzero on 8 head dims only, under a
    scale of 1/8: every score is exact in f32 whatever the summation order,
    lies on the Δ grid and within one logit unit, so no score can flip a Δ
    rounding and every online correction is a fine Q1.15 factor."""
    n, h, hkv, d, bs = SLOTS, 16, 8, 128, BLOCK
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


def attn_bound(args, lengths, n_valid, kv_item: int, scales: bool) -> tuple[float, str]:
    """Bytes: every live K/V block once (``kv_item`` bytes an element, plus
    its two f32 scales in int8 mode), q read and out written once, the
    tables and per-sequence ints; operations: q.k and p.v over the visible
    (row, column) pairs."""
    q = args[0]
    n, _, h, d = q.shape
    hkv, item = args[1].shape[2], q.element_size()
    blocks = sum(-(-int(L) // BLOCK) for L in lengths)
    nbytes = (2 * blocks * BLOCK * hkv * d * kv_item + (2 * 4 * blocks if scales else 0)
              + 2 * q.numel() * item + 4 * (args[3].numel() + 2 * n))
    seen = sum(min(int(L) - int(nv) + i + 1, int(L)) for L, nv in zip(lengths, n_valid)
               for i in range(int(nv)))  # visible columns over the valid rows
    return bound(nbytes, 4 * h * d * seen, q.dtype)


def attn_case(c: int, dtype, gen, max_bt: int = 66) -> dict:
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    args, lengths, n_valid = attn_inputs(c, dtype, gen, max_bt=max_bt)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    got = attn_ops.gn_paged_attention_chunk(*args)
    check = compare(got[lane], attn_ref.gn_paged_attention_chunk_ref(*args)[lane],
                    ATTN_ATOL_F32, rel)
    # scores exact, on the Δ grid and one logit wide: no flip is possible,
    # so every row must agree to the Q1.15 rounding of the corrections alone
    ex_args, _, _ = attn_inputs(c, dtype, gen, exact=True, max_bt=max_bt)
    exact = compare(attn_ops.gn_paged_attention_chunk(*ex_args, sm_scale=1 / 8)[lane],
                    attn_ref.gn_paged_attention_chunk_ref(*ex_args, sm_scale=1 / 8)[lane],
                    EXACT_ATOL, rel)
    # exact-ones: V = 1 turns each valid row into sum(p) = 1
    ones_args, _, _ = attn_inputs(c, torch.float32, gen, v_ones=True, max_bt=max_bt)
    ones_err = (attn_ops.gn_paged_attention_chunk(*ones_args)[lane] - 1.0).abs().max().item()
    empty_read = got[3].abs().max().item()  # the empty sequence must read nothing
    poison = poisoned_rows(args, lane) if max_bt == 66 else {}
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL and empty_read == 0.0
                   and all(p["equal"] for p in poison.values()))
    if poison:
        check["poisoned"] = poison
    n, _, h, d = args[0].shape
    hkv = args[1].shape[2]
    b_ms, b_by = attn_bound(args, lengths, n_valid, args[1].element_size(), False)
    return {
        "name": "gn_paged_attention", "design": attn_ops.call_design(*args[:3]),
        "shape": {"N": n, "C": c, "H": h, "Hkv": hkv, "D": d, "block": BLOCK,
                  "max_len": int(lengths.max()),
                  "chain_ranges": attn_ops.chain_splits(n, hkv, max_bt, args[0].device)[0]},
        "dtype": str(dtype).split(".")[-1], **check,
        "exact_scores": {k: exact[k] for k in ("max_abs_err", "bad_rows")},
        "ones_err": ones_err, "empty_read": empty_read, "bound_ms": b_ms, "bound_by": b_by,
        **timings(lambda: attn_ops.gn_paged_attention_chunk(*args),
                  lambda: attn_ref.gn_paged_attention_chunk_ref(*args), None, 20),
    }


def poisoned_rows(args, lane) -> dict:
    """The first block of every other live sequence set to NaN or +Inf in
    K or in V: per valid row, the kernel's output is finite exactly where
    its plain version's is (a K tile's nonfinite scores are laundered by
    the GN exponential; a V tile reaches the rows that read it), and its
    per-row flags of a nonfinite live score equal the plain version's (set
    on the rows that read a poisoned K tile, nowhere for a V tile)."""
    q, k, v, tables, *ints = args
    blocks = [int(tables[i, 0]) for i in range(0, tables.shape[0], 2) if bool(lane[i].any())]
    out = {}
    for leaf in ("k", "v"):
        for value in (float("nan"), float("inf")):
            arenas = [k.clone(), v.clone()]
            arenas[leaf == "v"][blocks] = value
            poisoned = (q, *arenas, tables, *ints)
            outs = [fn(*poisoned, nonfinite=True) for fn in
                    (attn_ops.gn_paged_attention_chunk, attn_ref.gn_paged_attention_chunk_ref)]
            fin = [torch.isfinite(o.float()).flatten(2).all(-1)[lane] for o, _ in outs]
            flags = [f[lane] for _, f in outs]
            out[f"{leaf}-{value}"] = {"finite_rows": int(fin[0].sum()),
                                      "plain_finite_rows": int(fin[1].sum()),
                                      "flagged_rows": int(flags[0].any(-1).sum()),
                                      "rows": int(lane.sum()),
                                      "equal": torch.equal(*fin) and torch.equal(*flags)
                                      and bool(flags[0].any()) == (leaf == "k")}
    return out


def quantize(arena):
    """An (nb, bs, Hkv, D) fp arena as the int8 pool holds it: (nb + 1)
    int8 blocks (the last is the write sink) and (nb + 1,) f32 scales,
    written in one call of ``paged_quant_write`` on the card."""
    nb, bs, hkv, d = arena.shape
    q8 = torch.zeros((nb + 1) * bs, hkv, d, dtype=torch.int8, device=DEV)
    scale = torch.zeros(nb + 1, device=DEV)
    attention_mod.paged_quant_write(q8, scale, arena.reshape(nb * bs, hkv, d),
                                    torch.arange(nb * bs, device=DEV), bs)
    return q8.view(nb + 1, bs, hkv, d), scale


def attn_int8_case(c: int, dtype, gen, max_bt: int = 66) -> dict:
    """The int8 mode against its plain version: random arenas quantized on
    the card; exact scores (k in {-1, 0, 1} stored at scale 1, q likewise,
    sm_scale 1/8); V = 1 stored at scale 1; the empty sequence."""
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    (q, k_fp, v_fp, *ints), lengths, n_valid = attn_inputs(c, dtype, gen, max_bt=max_bt)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    (k8, ks), (v8, vs) = quantize(k_fp), quantize(v_fp)
    del k_fp, v_fp
    args, scales = (q, k8, v8, *ints), (ks, vs)
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    check = compare(got[lane], attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)[lane],
                    ATTN_ATOL_F32, rel)
    (eq, ek, ev, *eints), _, _ = attn_inputs(c, dtype, gen, exact=True, max_bt=max_bt)
    ev8, evs = quantize(ev)
    ek8 = torch.cat([ek.to(torch.int8), torch.zeros_like(ek[:1], dtype=torch.int8)])
    ex_args, ex_scales = (eq, ek8, ev8, *eints), (torch.ones_like(evs), evs)
    exact = compare(
        attn_ops.gn_paged_attention_chunk(*ex_args, sm_scale=1 / 8, scales=ex_scales)[lane],
        attn_ref.gn_paged_attention_chunk_ref(*ex_args, sm_scale=1 / 8, scales=ex_scales)[lane],
        EXACT_ATOL, rel)
    del eq, ek, ev, ek8, ev8
    ones = attn_ops.gn_paged_attention_chunk(q.float(), k8, torch.ones_like(v8), *ints,
                                             scales=(ks, torch.ones_like(vs)))
    ones_err = (ones[lane] - 1.0).abs().max().item()
    empty_read = got[3].abs().max().item()
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL and empty_read == 0.0)
    n, _, h, d = q.shape
    b_ms, b_by = attn_bound(args, lengths, n_valid, 1, True)
    return {
        "name": "gn_paged_attention_int8", "design": attn_ops.call_design(*args[:3]),
        "shape": {"N": n, "C": c, "H": h, "Hkv": k8.shape[2], "D": d, "block": BLOCK,
                  "max_len": int(lengths.max()), "kv": "int8",
                  "chain_ranges": attn_ops.chain_splits(n, k8.shape[2], max_bt, q.device)[0]},
        "dtype": str(dtype).split(".")[-1], **check,
        "exact_scores": {k: exact[k] for k in ("max_abs_err", "bad_rows")},
        "ones_err": ones_err, "empty_read": empty_read, "bound_ms": b_ms, "bound_by": b_by,
        **timings(lambda: attn_ops.gn_paged_attention_chunk(*args, scales=scales),
                  lambda: attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales), None, 20),
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


SOFTMAX_LAYOUTS = {"gn_softmax_warp_kernel": "warp", "gn_softmax_block_kernel": "block",
                   "gn_softmax_row_kernel": "row"}


def softmax_layouts(fn) -> list[str]:
    """The softmax layouts a call of ``fn`` ran, read from the kernel names
    of its device trace (a warp per row, a block per row, or the three-pass
    row kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({layout for key in _device_us(prof) for name, layout in SOFTMAX_LAYOUTS.items()
                   if name in key})


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
        res.update(bound_ms=b_ms, bound_by=b_by,
                   layout=softmax_layouts(lambda: sm_ops.gn_softmax(x, cfg)), **timings(
                       lambda: sm_ops.gn_softmax(x, cfg), lambda: sm_ref.gn_softmax_ref(x, cfg),
                       lambda: torch.softmax(x, dim=-1), iters))
    return res


def softmax_cases(gen) -> list[dict]:
    """The prefill's causally masked score rows (B·H·S, S) and a decode
    step's (B·H, max_seq) with the tail past pos masked, both f32 as the
    model casts its scores, and the long phases' decode rows (4128 and 8224
    columns); a bf16 case, a ragged case, a vocab-wide row set (the
    wide-row path) and the reference's three LUT configs."""
    out = []
    x, masked = softmax_rows(BATCH * 16 * PROMPT, PROMPT, torch.float32, gen,
                             visible=lambda r: r % PROMPT)
    out.append(softmax_case("prefill", x, masked, iters=10))
    del x, masked
    pos = PROMPT + NEW // 2
    x, masked = softmax_rows(BATCH * 16, PROMPT + NEW, torch.float32, gen,
                             visible=lambda r: torch.full_like(r, pos))
    out.append(softmax_case("decode", x, masked, iters=50))
    for b, s in LONG_BATCHES:  # the long phases' decode rows: (B·H, S + NEW)
        x, masked = softmax_rows(b * 16, s + NEW, torch.float32, gen,
                                 visible=lambda r, p=s + NEW // 2: torch.full_like(r, p))
        out.append(softmax_case(f"decode-{s + NEW}", x, masked, iters=50))
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
    oq, ok_, ov = fa_inputs(shape, dtype, gen, v_ones=True)
    ones_err = (fa_ops.gn_attention(oq, ok_, ov, causal=causal).float() - 1.0).abs().max().item()
    del oq, ok_, ov
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL)
    res = {"name": "gn_attention", "case": label, "design": fa_ops.design(dtype, TPU_SOFTMAX_LUT),
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


def fa_long_case(b: int, s: int, gen, iters: int = 5) -> dict:
    """The flash attention at a long prefill's shape (B, 16, 8, S, S, 128),
    causal, bf16.  The kernel runs the whole shape; its first kv head's
    group (q heads 0 and 1) is held against the plain version on that group
    alone, whose (B, 2, S, S) f32 scores fit where the whole shape's would
    not; V = 1 over the whole shape.  Device times of the whole shape beside
    its bound and SDPA; the plain version's time is the group's."""
    shape = (b, 16, 8, s, s, 128)
    q, k, v = fa_inputs(shape, torch.bfloat16, gen)
    group = [t[:, :n].contiguous() for t, n in ((q, 2), (k, 1), (v, 1))]
    check = compare(fa_ops.gn_attention(q, k, v, causal=True)[:, :2],
                    fa_ref.gn_attention_ref(*group, causal=True), ATTN_ATOL_F32, BF16_REL)
    ones = fa_ops.gn_attention(q, k, torch.ones_like(v), causal=True)
    ones_err = (ones.float() - 1.0).abs().max().item()
    del ones
    check["ok"] = check["bad_rows"] <= FLIP_ROWS * check["rows"] and ones_err <= ONES_ATOL
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                       4 * b * 16 * 128 * (s * (s + 1) // 2), torch.bfloat16)
    lib = functools.partial(F.scaled_dot_product_attention, q, k, v, is_causal=True,
                            enable_gqa=True)
    return {"name": "gn_attention", "case": f"prefill-{s}",
            "design": fa_ops.design(torch.bfloat16, TPU_SOFTMAX_LUT),
            "shape": {"B": b, "H": 16, "Hkv": 8, "Sq": s, "Sk": s, "D": 128, "causal": True},
            "dtype": "bfloat16", **check, "ones_err": ones_err, "bound_ms": b_ms,
            "bound_by": b_by, "ms": device_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True),
                                              iters),
            "call_ms": call_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True), iters),
            "plain_ms": None, "plain_group_ms": device_ms(
                lambda: fa_ref.gn_attention_ref(*group, causal=True), 3),
            "library_ms": device_ms(lib, iters)}


def attention_cases(gen) -> list[dict]:
    """The forward's shape (B 8, H 16, Hkv 8, S = prompt + new, D 128,
    causal) in bf16 and f32, a non-causal case, a KV-prefix case (Sk > Sq,
    the causal offset), a ragged S, and the long prefills' shapes."""
    fwd = (BATCH, 16, 8, PROMPT + NEW, PROMPT + NEW, 128)
    return [fa_case("forward", fwd, torch.bfloat16, True, gen, iters=10),
            fa_case("forward", fwd, torch.float32, True, gen, iters=5),
            fa_case("non-causal", (2, 16, 8, 256, 256, 128), torch.bfloat16, False, gen),
            fa_case("kv-prefix", (1, 8, 1, 64, 256, 32), torch.float32, True, gen),
            fa_case("ragged", (2, 16, 8, 333, 333, 128), torch.float32, True, gen)] + [
                fa_long_case(b, s, gen) for b, s in LONG_BATCHES]


def st_softmax(x):
    """The plain GN softmax under plain autograd, with the reference's
    straight-through Jacobian: the plain version's value c, the exact
    softmax derivative at c (c + t - t.detach(), t = c (x - Σ c x))."""
    c = sm_ref.gn_softmax_ref(x.detach())
    t = c * (x - (c * x).sum(dim=-1, keepdim=True))
    return c + t - t.detach()


def st_norm(s, gamma, beta, subtract_mean: bool):
    """The plain GN norm under plain autograd with the straight-through
    Jacobian: rstd = newton_rsqrt(var + 1e-8) in value, d rstd / d var the
    exact rsqrt's at it (-rstd^3 / 2)."""
    s32 = s.float()
    c = s32 - s32.mean(dim=-1, keepdim=True) if subtract_mean else s32
    var = c.square().mean(dim=-1, keepdim=True)
    r = newton_rsqrt(var.detach() + 1e-8)
    y = c * (r - 0.5 * r ** 3 * (var - var.detach())) * gamma
    return (y if beta is None else y + beta).to(s.dtype)


def st_attention(q, k, v, causal: bool):
    """One-pass attention in f32 through ``st_softmax``, kv heads repeated."""
    group = q.shape[1] // k.shape[1]
    k32, v32 = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k32) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", st_softmax(s), v32)


def grads_of(fn, inputs, weights) -> list:
    """d/d inputs of Σ fn(*inputs) ⊙ weights (fn may return a tuple)."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return list(torch.autograd.grad(sum((o.float() * w).sum() for o, w in zip(out, weights)),
                                    leaves))


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def backward_cases(gen) -> list[dict]:
    """Each differentiable kernel wrapper's gradient on the card (the
    kernel forward, the plain backward) against plain autograd through its
    plain version with the straight-through Jacobian, at f32 at the
    training shapes (a microbatch of TRAIN_BATCH / TRAIN_MB sequences of
    TRAIN_SEQ tokens) cut to 2 q heads (one kv head's group): the flash
    backward's recompute rows for the softmax, the (B·S, 2048) rows for the
    norm (RMS, LayerNorm, the fused add), the flash attention in f32 (its
    CUDA-core design) and bf16 (its tensor-core design)."""
    b, s, d, cols = TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, 128, 2048
    res = []

    def draw(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    mask = torch.ones(s, s, dtype=torch.bool, device=DEV).tril()
    x = torch.where(mask, 3 * draw(b, 2, s, s), -1e30)
    w = [draw(*x.shape)]
    got = grads_of(sm_ops.gn_softmax, [x], w)
    want = grads_of(st_softmax, [x], w)
    res.append({"name": "gn_softmax", "case": "flash-backward rows", "shape": list(x.shape),
                "dtype": "float32", "rel_l2": [rel_l2(got[0], want[0])],
                "tol": GRAD_REL["softmax"]})
    for mean in (False, True):
        xs, rs = draw(b * s, cols), draw(b * s, cols)
        gamma, beta = 1 + 0.1 * draw(cols), (0.1 * draw(cols) if mean else None)
        inputs = [xs, gamma] + ([beta] if mean else [])
        w = [draw(b * s, cols)]
        fn = ((lambda a, g, be: norm_ops.gn_layernorm(a, g, be)) if mean
              else (lambda a, g: norm_ops.gn_rmsnorm(a, g)))
        ref = ((lambda a, g, be: st_norm(a, g, be, True)) if mean
               else (lambda a, g: st_norm(a, g, None, False)))
        res.append({"name": "gn_rmsnorm", "case": "LayerNorm" if mean else "RMS",
                    "shape": [b * s, cols], "dtype": "float32", "tol": GRAD_REL["norm"],
                    "rel_l2": [rel_l2(g, h) for g, h in zip(grads_of(fn, inputs, w),
                                                            grads_of(ref, inputs, w))]})
        w2 = [draw(b * s, cols), w[0]]
        fused = ((lambda a, r, g, be: norm_ops.gn_add_layernorm(a, r, g, be)) if mean
                 else (lambda a, r, g: norm_ops.gn_add_rmsnorm(a, r, g)))
        fused_ref = ((lambda a, r, g, be: (a + r, st_norm(a + r, g, be, True))) if mean
                     else (lambda a, r, g: (a + r, st_norm(a + r, g, None, False))))
        inputs = [xs, rs, gamma] + ([beta] if mean else [])
        res.append({"name": "gn_rmsnorm_fused", "case": "LayerNorm" if mean else "RMS",
                    "shape": [b * s, cols], "dtype": "float32", "tol": GRAD_REL["norm"],
                    "rel_l2": [rel_l2(g, h) for g, h in zip(grads_of(fused, inputs, w2),
                                                            grads_of(fused_ref, inputs, w2))]})
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = draw(b, 2, s, d, dtype=dtype), draw(b, 1, s, d, dtype=dtype), draw(
            b, 1, s, d, dtype=dtype)
        w = [draw(b, 2, s, d)]
        got = grads_of(lambda a, c, e: fa_ops.gn_attention(a, c, e, causal=True), [q, k, v], w)
        want = grads_of(lambda a, c, e: st_attention(a, c, e, True),
                        [t.float() for t in (q, k, v)], w)
        name = str(dtype).split(".")[-1]
        tol = GRAD_REL[f"attention_{name}"]
        # dq per q row: within tol of the largest |dq|, a budget of FLIP_ROWS
        # rows past it (a Δ-grid flip in the kernel's forward)
        rows = compare(got[0], want[0], tol * want[0].abs().max().item())
        def step(q=q, k=k, v=v, w=w):
            return grads_of(lambda a, c, e: fa_ops.gn_attention(a, c, e, causal=True),
                            [q, k, v], w)
        res.append({"name": "gn_attention", "case": "causal", "shape": [b, 2, 1, s, s, d],
                    "dtype": name, "design": fa_ops.design(dtype, TPU_SOFTMAX_LUT),
                    "rel_l2": [rel_l2(g, h) for g, h in zip(got, want)], "tol": tol,
                    "dq_bad_rows": rows["bad_rows"], "dq_rows": rows["rows"],
                    "fwd_bwd_call_ms": call_ms(step, 5)})
    for r in res:
        r["ok"] = (all(math.isfinite(e) and e <= r["tol"] for e in r["rel_l2"])
                   and r.get("dq_bad_rows", 0) <= FLIP_ROWS * r.get("dq_rows", 1))
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    norms, fused_norms = norm_cases(gen)
    attns = [attn_case(c, dt, gen) for c in (CHUNK, 1) for dt in (torch.bfloat16, torch.float32)]
    attns.append(attn_case(CHUNK, torch.bfloat16, gen, max_bt=LONG_BT))
    softmaxes = softmax_cases(gen)
    flashes = attention_cases(gen)
    attns_int8 = [attn_int8_case(c, torch.bfloat16, gen) for c in (CHUNK, 1)]
    attns_int8.append(attn_int8_case(CHUNK, torch.bfloat16, gen, max_bt=LONG_BT))
    results = norms + fused_norms + attns + attns_int8 + softmaxes + flashes
    for r in results:
        print(f"[kernels] {json.dumps(r)}")
    backward = backward_cases(gen)
    for r in backward:
        print(f"[backward] {json.dumps(r)}")
    bad = [f"{r['name']} {r.get('case', '')} {r['dtype']} {r['shape']}"
           for r in results + backward if not r["ok"]]
    if bad:
        fail(f"kernel vs plain out of tolerance: {bad}")
    return {"gn_rmsnorm": norms, "gn_rmsnorm_fused": fused_norms, "gn_paged_attention": attns,
            "gn_paged_attention_int8": attns_int8, "gn_softmax": softmaxes,
            "gn_attention": flashes}


# ------------------------------------------------------------------ phase 3 --
def tick_parity(base, master) -> dict:
    """One fused tick: slot 0 prefills 16 tokens from 0, slot 1 decodes at 100,
    slot 2 prefills 7 tokens at 48, slot 3 is parked; over fp arenas and
    over int8 arenas with per-block scales.  The tick also runs on the card
    with the plain paged read swapped in, which splits the gap into the
    read's share and the rest's (matmuls, norm kernel).  In int8 the largest
    difference of a written int8 value and of a real block's scale (relative)
    are printed: the K/V projections round apart on the card and on the CPU,
    so a value at a .5 boundary of the grid may land one step apart."""
    rng = np.random.default_rng(1)
    positions = np.array([0, 100, 48, 0], np.int32)
    n_valid = np.array([16, 1, 7, 0], np.int32)
    tokens = rng.integers(0, base.vocab, size=(4, 16)).astype(np.int32)
    tables = rng.permutation(48)[:32].reshape(4, 8).astype(np.int32)

    def tick(model, dev, kv_dtype):
        params = model.prepare(master, dev)
        cache = model.init_paged_cache(48, BLOCK, dev, kv_dtype)
        # prior context: random N(0, 1) arena contents; an int8 pool holds the
        # same values as paged_quant_write stores them, layer by layer
        g = torch.Generator().manual_seed(2)
        for key in ("k", "v"):
            prior = torch.randn(cache[key].shape, generator=g)
            if kv_dtype == "fp":
                cache[key].copy_(prior.to(cache[key].dtype))
                continue
            rows = torch.arange(prior.shape[1] * BLOCK, device=dev)
            for arena, scale, vals in zip(cache[key], cache[f"{key}_scale"], prior.to(dev)):
                attention_mod.paged_quant_write(arena.flatten(0, 1), scale, vals.flatten(0, 1),
                                                rows, BLOCK)
        t = [torch.as_tensor(a).to(dev) for a in (tokens, positions, n_valid, tables)]
        logits = model.fused_step_slots_paged(params, cache, *t).float().cpu()
        return logits, {k: v[:, :48].cpu() for k, v in cache.items()}

    errs = {}
    for kv_dtype in ("fp", "int8"):
        for dt, tol in (("float32", LOGITS_ATOL_F32), ("bfloat16", LOGITS_ATOL_BF16)):
            model = make_model(dataclasses.replace(base, dtype=dt))
            cpu, cpu_cache = tick(model, "cpu", kv_dtype)
            got, got_cache = tick(model, DEV, kv_dtype)
            err = (got - cpu).abs().max().item()
            with swapped("gn_paged_attention_chunk", attn_ref.gn_paged_attention_chunk_ref):
                plain_read_err = (tick(model, DEV, kv_dtype)[0] - cpu).abs().max().item()
            extra = ""
            if kv_dtype == "int8":
                int8_diff = max((got_cache[k].int() - cpu_cache[k].int()).abs().max().item()
                                for k in ("k", "v"))
                scale_rel = max(((got_cache[k] - cpu_cache[k]).abs()
                                 / cpu_cache[k].abs().clamp_min(1e-30)).max().item()
                                for k in ("k_scale", "v_scale"))
                extra = f"; max int8 diff {int8_diff}, max relative scale diff {scale_rel:.3e}"
            print(f"[parity] {ARCH} 2 layers {dt} fused tick, {kv_dtype} KV: max |logit diff| "
                  f"{err:.3e} (plain paged read on the card: {plain_read_err:.3e}; "
                  f"max |logit| {cpu.abs().max().item():.3f}, bound {tol}{extra})")
            errs[dt if kv_dtype == "fp" else f"int8 {dt}"] = err
            if dt == "float32":
                read_parity(tick, model, kv_dtype, got, torch.as_tensor(n_valid > 0))
    return errs


def read_parity(tick, model, kv_dtype: str, kernel_logits, live) -> None:
    """The f32 tick on the card through the reference's two jnp reads
    (``FORCE_PAGED_READ``): the streamed read against the gathered read
    (bitwise expected: each score is the same dot; STREAMED_ATOL bounds it
    if cuBLAS picks another reduction for a tile's shape than for the whole
    stream's) and, on the ``live`` slots, the kernel read against the
    streamed read (the online read against the one-pass one, phase 3's f32
    logits bound).  A parked slot's logits are don't-care: the kernel reads
    nothing for it, the jnp reads read its row 0."""
    reads = {}
    for path in ("streamed", "gathered"):
        with swapped("FORCE_PAGED_READ", path):
            reads[path] = tick(model, DEV, kv_dtype)[0]
    bitwise = torch.equal(reads["streamed"], reads["gathered"])
    sg = (reads["streamed"] - reads["gathered"]).abs().max().item()
    ks = (kernel_logits - reads["streamed"])[live].abs().max().item()
    print(f"[parity] {ARCH} 2 layers float32 fused tick, {kv_dtype} KV, paged reads: streamed vs "
          f"gathered bitwise {bitwise} (max |diff| {sg:.3e}, bound {STREAMED_ATOL}); kernel vs "
          f"streamed max |logit diff| {ks:.3e} (bound {LOGITS_ATOL_F32})")
    if not sg <= STREAMED_ATOL or not ks <= LOGITS_ATOL_F32:
        fail(f"paged reads at {kv_dtype}: streamed vs gathered {sg:.3e}, kernel vs streamed "
             f"{ks:.3e}")


class swapped:
    """Set a name of ``models.attention`` for a block: a kernel wrapper to its
    plain version, or ``FORCE_PAGED_READ`` to a read."""

    def __init__(self, name: str, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.saved = getattr(attention_mod, self.name)
        setattr(attention_mod, self.name, self.value)

    def __exit__(self, *exc):
        setattr(attention_mod, self.name, self.saved)


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
        for key, err in by_dtype.items():
            tol = LOGITS_ATOL_F32 if key.endswith("float32") else LOGITS_ATOL_BF16
            if not math.isfinite(err) or err > tol:
                fail(f"model parity ({path}) at {key}: {err:.3e} > {tol}")
    return errs


# ------------------------------------------------------------------ phase 4 --
def window_run(engine, reqs, start: int, ticks: int, trace: bool = False):
    """A reset rerun of ``reqs`` whose model ticks [start, start + ticks)
    run apart, timed on the host clock (and under the profiler, with
    ``trace``): (request id -> new tokens, the window's seconds, the trace
    or None)."""
    engine.reset()
    for req in reqs:
        engine.submit(req)
    while engine.model_ticks < start and engine.step():
        pass

    def window():
        while engine.model_ticks < start + ticks and engine.step():
            pass

    if trace:
        _, prof, seconds = profiled(window)
    else:
        prof, (_, ms) = None, timed(window)
        seconds = ms / 1e3
    while engine.step():
        pass
    return {c.request_id: c.new_tokens for c in engine.completions}, seconds, prof


def continuous_replays(label: str, engine, reqs, first: dict, want: dict, eager: bool = True,
                       window: int | None = None) -> dict:
    """After a continuous path's first run (which captured its graphs): the
    capture contract; a timed rerun, every tick a replay, with its launch
    counters gated as the first run's; a profiled rerun (device busy, top
    kernels, the GN kernels' device records against the launches), or with
    ``window`` a rerun that profiles that many model ticks from the middle
    of the run, its busy share taken against the same ticks of an untraced
    rerun; then (``eager``) the eager tick on the same workload, bitwise
    against the graphed one."""
    m = engine.metrics()
    check_graphs(label, m)
    captures = (m["fused_step_compilations"], m["decode_compilations"])
    counters.reset()
    again, steady_s = timed_run(engine, reqs)
    if counters.launch_counts() != want:
        fail(f"{label}: replayed launches {counters.launch_counts()} != {want}")
    if any(not np.array_equal(first[i], again[i]) for i in first):
        fail(f"{label}: reset + rerun gave different tokens")
    m = engine.metrics()
    check_graphs(label, m)
    if (m["fused_step_compilations"], m["decode_compilations"]) != captures:
        fail(f"{label}: the rerun captured again: {captures} -> {m}")
    steady_tick_ms = [dt * 1e3 for _, _, dt in engine.tick_log]
    state = engine_state(engine)
    ticks = m["model_ticks"]

    def same(toks: dict) -> None:
        if any(not np.array_equal(first[i], toks[i]) for i in first):
            fail(f"{label}: the profiled rerun gave different tokens")

    if window is None:
        def rerun():
            engine.reset()
            toks, prof, seconds = profiled(
                lambda: {c.request_id: c.new_tokens for c in engine.run(reqs)})
            same(toks)
            return toks, prof, seconds

        traced, base_s = ticks, steady_s
    else:
        traced = min(window, ticks)
        start = (ticks - traced) // 2
        toks, base_s, _ = window_run(engine, reqs, start, traced)
        if any(not np.array_equal(first[i], toks[i]) for i in first):
            fail(f"{label}: the windowed rerun gave different tokens")

        def rerun():
            toks, seconds, prof = window_run(engine, reqs, start, traced, trace=True)
            same(toks)
            return toks, prof, seconds

    # every model tick launches alike, so the traced ticks' share of the launches
    _, prof, rerun_s, records, traces = traced_rerun(label, rerun, {
        name: sum(want[k] for k in keys) * traced // ticks for name, keys in (
            ("gn_paged_attention", ("gn_paged_attention", "gn_paged_attention_int8")),
            ("gn_rmsnorm", ("gn_rmsnorm",)), ("gn_softmax", ("gn_softmax",)),
            ("gn_attention", ("gn_attention",)))})
    per_kernel = _device_us(prof)
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    # the trace slows the replays down several times, so the busy share is
    # taken against the untraced rerun's wall time of the same ticks
    print(f"[{label}-profile] {traced} of {ticks} ticks traced: device busy {busy_s:.3f}s: "
          f"{100 * busy_s / base_s:.1f}% of the untraced rerun's {base_s:.3f}s "
          f"({100 * busy_s / rerun_s:.1f}% of the traced rerun's {rerun_s:.3f}s); GN kernel "
          f"records {json.dumps(records)} (trace {traces}); top kernels (s): "
          + json.dumps({k[:60]: v / 1e6 for k, v in top}))
    eager = eager_against_graphed(label, engine, reqs, first, state) if eager else {}
    return {"captures": {"fused": captures[0], "decode": captures[1]},
            "fused_buckets": m["fused_buckets"], "decode_buckets": m["decode_buckets"],
            "capture_seconds": m["capture_seconds"], "steady_seconds": steady_s,
            "steady_tokens_per_s": m["generated_tokens"] / steady_s,
            "steady_mean_tick_ms": float(np.mean(steady_tick_ms)),
            "profiled_ticks": traced, "profiled_rerun_seconds": rerun_s, "traces": traces,
            "device_busy_seconds": busy_s, "device_busy_share": busy_s / base_s,
            "kernel_records": records, **eager}


def continuous_want(layers: int, ticks: int, int8: bool, read_path: str = "kernel",
                    sentinels: bool = True) -> dict:
    """The launches of ``ticks`` paged ticks: 24 paged reads (fp or int8
    mode; with the streamed or gathered read 24 softmaxes instead), 49 norms
    (with the sentinels 50: the head's σ probe) and 47 of them fused, a
    tick."""
    read = layers * ticks
    kernel = read_path == "kernel"
    return {"gn_rmsnorm": (2 * layers + 1 + sentinels) * ticks,
            "gn_rmsnorm_fused": (2 * layers - 1) * ticks,
            "gn_paged_attention": read if kernel and not int8 else 0,
            "gn_paged_attention_int8": read if kernel and int8 else 0,
            "gn_softmax": 0 if kernel else read, "gn_attention": 0}


def phase_serve() -> dict:
    counters.reset()
    out = serve_mod.main([
        "--arch", ARCH, "--continuous", "--seed", str(SEED), "--num-slots", str(SLOTS),
        "--chunk", str(CHUNK), "--block-size", str(BLOCK), "--requests", str(REQUESTS),
        "--min-prompt", str(MIN_PROMPT), "--max-prompt", str(MAX_PROMPT),
        "--new-tokens", str(NEW), "--stagger", "1",
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
    want = continuous_want(layers, ticks, int8=False)
    if launches != want:
        fail(f"continuous serving launches {launches} != {want}")
    if plain_on_cuda:
        fail(f"{plain_on_cuda} plain-version calls on CUDA tensors in the serving run")
    if not bool(torch.isfinite(engine._last_logits).all()):
        fail("non-finite logits")
    check_silent("serve", engine)
    first = {c.request_id: c.new_tokens for c in comps}
    replays = continuous_replays("serve", engine, reqs, first, want)
    res = {
        "requests": len(comps), "generated_tokens": m["generated_tokens"],
        "seconds": out["seconds"], "tokens_per_s": m["generated_tokens"] / out["seconds"],
        "model_ticks": ticks, "fused_ticks": m["fused_ticks"],
        "mean_tick_ms": float(np.mean(tick_ms)), "launches": launches,
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)), **replays,
        # online paged read vs one-pass static softmax: reported, not gated
        "static_identical": f"{out['static_identical']}/{len(comps)}",
        "mean_common_prefix": float(np.mean(out["common_prefix"])),
        "kv_hbm_bytes": engine.pool.hbm_bytes(), "num_blocks": engine.pool.num_blocks,
        **{k: m[k] for k in ("sentinel_checks", "sentinel_peak_sum_residual",
                             "sentinel_peak_sigma_residual")},
    }
    print(f"[serve] {json.dumps(res)}")
    return {**res, "new_tokens": first}


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
    want = {"gn_rmsnorm": BATCHES * (2 * layers + 1) * (NEW + 2),
            "gn_rmsnorm_fused": BATCHES * (2 * layers - 1) * (NEW + 2), "gn_paged_attention": 0,
            "gn_paged_attention_int8": 0, "gn_softmax": BATCHES * layers * (1 + NEW),
            "gn_attention": BATCHES * layers}
    if launches != want or out["launches"] != want:
        fail(f"static launches {launches} (run: {out['launches']}) != {want}")
    if any(plain.values()):
        fail(f"plain-version calls on CUDA tensors in the static run: {plain}")
    if not all(math.isfinite(p) for p in out["perplexities"]):
        fail(f"non-finite perplexity {out['perplexities']}")
    prompt = out["prompts"][0]
    # the rerun runs under a CUDA-only profiler: device busy time, the
    # kernels that take it, and the GN kernels' records (the prefill and
    # NEW decode steps, each a graph replay) against the launches
    again, untraced_ms = timed(
        lambda: generate(model, params, {"tokens": prompt}, ServeConfig(max_new_tokens=NEW)))
    if not torch.equal(again, out["outputs"][0]):
        fail("a rerun of batch 0 gave different tokens")

    def rerun():
        again, prof, seconds = profiled(
            lambda: generate(model, params, {"tokens": prompt}, ServeConfig(max_new_tokens=NEW)))
        if not torch.equal(again, out["outputs"][0]):
            fail("a profiled rerun of batch 0 gave different tokens")
        return again, prof, seconds

    _, prof, rerun_s, records, traces = traced_rerun("static", rerun, {
        "gn_paged_attention": 0, "gn_rmsnorm": (2 * layers + 1) * (NEW + 1),
        "gn_softmax": layers * (NEW + 1), "gn_attention": 0})
    per_kernel = _device_us(prof)
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[static-profile] generate of batch 0: device busy {busy_s:.3f}s: "
          f"{100 * busy_s / (untraced_ms / 1e3):.1f}% of the untraced run's "
          f"{untraced_ms / 1e3:.3f}s ({100 * busy_s / rerun_s:.1f}% of the traced run's "
          f"{rerun_s:.3f}s); GN kernel records {json.dumps(records)} (trace {traces}); "
          "top kernels (s): " + json.dumps({k[:60]: v / 1e6 for k, v in top}))
    decoders = model.__dict__.get("_static_decoders", {})
    if {k: d.graphs.captures for k, d in decoders.items()} != {(BATCH, PROMPT + NEW):
                                                               {"decode": 1}}:
        fail(f"static decode graphs {[(k, d.graphs.captures) for k, d in decoders.items()]} "
             f"!= one capture for ({BATCH}, {PROMPT + NEW})")
    # prefill, then decode steps: the eager step (int position) and the
    # replayed graph on the same tokens, their logits bit for bit
    (logits, cache), prefill_ms = timed(
        lambda: model.prefill(params, {"tokens": prompt}, PROMPT + NEW))
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite prefill logits")
    decode = static_decoder(model, params, BATCH, PROMPT + NEW, torch.device(DEV))
    model.prefill(params, {"tokens": prompt}, PROMPT + NEW, cache=decode.cache)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    del logits
    step_ms, eager_ms = [], []
    for i in range(min(8, NEW)):
        (step, cache), ms = timed(lambda: model.decode_step(params, cache, nxt, PROMPT + i))
        eager_ms.append(ms)
        graphed, ms = timed(lambda: decode(nxt, PROMPT + i))
        step_ms.append(ms)
        if not bool(torch.isfinite(step).all()):
            fail("non-finite decode logits")
        if not torch.equal(graphed, step):
            fail(f"the replayed decode step's logits differ from the eager step's at {i}")
        nxt = step[:, 0].argmax(-1).to(torch.int32)[:, None]
    del cache, step
    # batch 0's teacher-forced perplexity: the 24-layer forward over 8 x 1056
    # tokens, one flash-attention launch a layer; timed, then profiled
    seqs = {"tokens": out["outputs"][0]}
    ppl, forward_ms = timed(lambda: perplexity(model, params, seqs))
    if not math.isfinite(ppl):
        fail(f"non-finite perplexity {ppl} in the timed forward")
    _, prof, _ = profiled(lambda: perplexity(model, params, seqs))
    per_kernel = _device_us(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[static-forward] perplexity of batch 0 ({BATCH} x {PROMPT + NEW} tokens, {layers} "
          f"layers): {forward_ms:.3f} ms on the host clock; profiled run busy "
          f"{sum(per_kernel.values()) / 1e3:.3f} ms on the device; top kernels (ms): "
          + json.dumps({k[:60]: v / 1e3 for k, v in top}))
    res = {"batches": BATCHES, "batch": BATCH, "prompt": PROMPT, "new_tokens": NEW,
           "layers": layers, "generated_tokens": out["generated_tokens"],
           "seconds": out["seconds"], "tokens_per_s": out["generated_tokens"] / out["seconds"],
           "batch_seconds": out["batch_seconds"], "perplexities": out["perplexities"],
           "optimal_perplexity": optimal_perplexity(out["data"]),
           "prefill_ms": prefill_ms, "decode_ms_per_step": float(np.mean(step_ms[1:])),
           "eager_decode_ms_per_step": float(np.mean(eager_ms[1:])),
           "captures": 1, "capture_seconds": decoders[BATCH, PROMPT + NEW].graphs.capture_seconds,
           "forward_ms": forward_ms,
           "generate_ms": untraced_ms, "profiled_rerun_seconds": rerun_s,
           "device_busy_seconds": busy_s, "device_busy_share": busy_s / (untraced_ms / 1e3),
           "kernel_records": records, "traces": traces,
           "launches": launches}
    print(f"[static] {json.dumps(res)}")
    return res


# ------------------------------------------------------------------ phase 6 --
def first_run(label: str, engine, reqs) -> tuple[dict, dict, float]:
    """A continuous path's first run, its graphs captured on the way, the
    launch counters set to 0 just before it and read just after: the exact
    launches of its ticks (for the engine's KV dtype and paged read), no
    plain version on a CUDA tensor, every request done with its budget,
    every block back, finite held logits.  Returns (request id -> new
    tokens, the launches, seconds)."""
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    want = continuous_want(engine.model.cfg.n_layers, engine.metrics()["model_ticks"],
                           engine.pool.kv_dtype == "int8", engine.read_path, engine.sentinels)
    if launches != want:
        fail(f"{label}: serving launches {launches} != {want}")
    if any(plain.values()):
        fail(f"{label}: plain-version calls on CUDA tensors in the serving run: {plain}")
    if len(comps) != len(reqs) or any(len(c.new_tokens) != r.max_new_tokens for c, r in
                                       zip(sorted(comps, key=lambda c: c.request_id), reqs)):
        fail(f"{label}: not every request completed with its budget")
    if engine.pool.blocks_in_use or engine.pool.num_free != engine.num_slots:
        fail(f"{label}: blocks not returned: {engine.pool.blocks_in_use} in use")
    if not bool(torch.isfinite(engine._last_logits).all()):
        fail(f"{label}: non-finite logits")
    check_silent(label, engine)
    return {c.request_id: c.new_tokens for c in comps}, launches, seconds


def check_silent(label: str, engine) -> None:
    """A fault-free run: with the sentinels on, every check within its bound."""
    m = engine.metrics()
    if m["sentinels"] and (m["sentinel_violations"] or not m["sentinel_checks"]):
        fail(f"{label}: {m['sentinel_violations']} sentinel violations in a clean run "
             f"({m['sentinel_checks']} checks)")


def common_prefix(toks: dict, ref: dict) -> list[float]:
    """Per request, the share of its new tokens before the first that
    differs from ``ref``'s."""
    out = []
    for i, t in toks.items():
        want = np.asarray(ref[i])[:len(t)]
        diff = np.nonzero(t[:len(want)] != want)[0]
        out.append((int(diff[0]) if diff.size else len(t)) / len(t))
    return out


def serve_stats(engine, seconds: float) -> dict:
    m = engine.metrics()
    return {"generated_tokens": m["generated_tokens"], "seconds": seconds,
            "tokens_per_s": m["generated_tokens"] / seconds, "model_ticks": m["model_ticks"],
            "fused_ticks": m["fused_ticks"],
            "mean_tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log])),
            **{k: m[k] for k in ("sentinel_checks", "sentinel_peak_sum_residual",
                                 "sentinel_peak_sigma_residual")}}


def phase_int8(served: dict) -> dict:
    """Phase 4's workload and weights over an int8 pool of the same block
    count, through the engine itself (the launcher has no KV dtype flag, as
    the reference's has none)."""
    model = make_model(get_config(ARCH))
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    engine = ContinuousEngine(model, model.init(SEED, DEV), num_slots=SLOTS,
                              max_seq=required_max_seq(reqs), chunk=CHUNK, block_size=BLOCK,
                              kv_dtype="int8", device=DEV)
    first, launches, seconds = first_run("int8", engine, reqs)
    if engine.pool.num_blocks != served["num_blocks"]:
        fail(f"int8 pool has {engine.pool.num_blocks} blocks, the fp pool {served['num_blocks']}")
    stats = serve_stats(engine, seconds)
    m = engine.metrics()
    replays = continuous_replays("int8", engine, reqs, first, launches)
    # greedy prefix shared with phase 4's fp tokens, per request (not gated)
    prefix = common_prefix(first, served["new_tokens"])
    res = {
        "requests": len(first), **stats, "launches": launches, **replays,
        "kv_hbm_bytes": engine.pool.hbm_bytes(), "fp_kv_hbm_bytes": served["kv_hbm_bytes"],
        "hbm_ratio": engine.pool.hbm_bytes() / served["kv_hbm_bytes"],
        "num_blocks": m["num_blocks"], "block_utilization": m["block_utilization"],
        "fp_common_prefix_mean": float(np.mean(prefix)),
        "fp_common_prefix_min": float(np.min(prefix)),
        "fp_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}",
    }
    print(f"[int8] {json.dumps(res)}")
    return {**res, "new_tokens": first}


# ------------------------------------------------------------------ phase 7 --
def phase_long_static(flashes: list[dict]) -> dict:
    """Prompts past 2048 tokens through the static path at full width: per
    batch of LONG_BATCHES, ``generate`` (NEW new tokens) with its launches
    exact (the prefill's 24 flash launches and no softmax, 24 softmax
    launches a decode step); the prefill alone (its launches again); eight
    replayed decode steps, timed, their logits finite, and the softmax
    layout their rows ran; the 4096-token batch's perplexity (finite: the
    8192 batch's f32 logits alone would take ~6 GB more).  Prints the flash
    kernel's phase 2 times at the same shapes beside them."""
    model = make_model(get_config(ARCH))
    params = model.prepare(model.init(SEED, DEV), DEV)
    layers = model.cfg.n_layers
    runs, total = [], dict.fromkeys(counters.WRAPPERS, 0)
    for b, s in LONG_BATCHES:
        data = DataConfig(vocab=model.cfg.vocab, seq_len=s, global_batch=b, seed=11)
        prompt = torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV)
        counters.reset()
        out, gen_ms = timed(lambda: generate(model, params, {"tokens": prompt},
                                             ServeConfig(max_new_tokens=NEW)))
        launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
        want = {"gn_rmsnorm": (2 * layers + 1) * (NEW + 1),
                "gn_rmsnorm_fused": (2 * layers - 1) * (NEW + 1), "gn_paged_attention": 0,
                "gn_paged_attention_int8": 0, "gn_softmax": layers * NEW, "gn_attention": layers}
        if launches != want or any(plain.values()):
            fail(f"long static ({b} x {s}): launches {launches} != {want}, plain {plain}")
        total = {k: total[k] + launches[k] for k in total}
        if tuple(out.shape) != (b, s + NEW):
            fail(f"long static: generate gave {tuple(out.shape)}")
        decode = static_decoder(model, params, b, s + NEW, torch.device(DEV))
        counters.reset()
        (logits, _), prefill_ms = timed(
            lambda: model.prefill(params, {"tokens": prompt}, s + NEW, cache=decode.cache))
        pre = counters.launch_counts()
        if pre["gn_attention"] != layers or pre["gn_softmax"]:
            fail(f"long static: the {s}-token prefill launched {pre}")
        if not bool(torch.isfinite(logits[:, -1]).all()):
            fail("long static: non-finite prefill logits")
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        del logits
        step_ms = []
        for i in range(8):
            step, ms = timed(lambda: decode(nxt, s + i))
            step_ms.append(ms)
            if not bool(torch.isfinite(step).all()):
                fail("long static: non-finite decode logits")
            nxt = step[:, 0].argmax(-1).to(torch.int32)[:, None]
        layout = softmax_layouts(lambda: decode(nxt, s + 8))
        run = {"prompts": b, "prompt_tokens": s, "decode_cols": s + NEW,
               "generate_ms": gen_ms, "tokens_per_s": b * NEW / (gen_ms / 1e3),
               "prefill_ms": prefill_ms, "decode_ms_per_step": float(np.mean(step_ms[1:])),
               "decode_softmax_layout": layout, "launches": launches}
        if s == LONG_BATCHES[0][1]:
            ppl = perplexity(model, params, {"tokens": out})
            if not math.isfinite(ppl):
                fail(f"long static: non-finite perplexity {ppl}")
            run["perplexity"] = ppl
        fa = next(f for f in flashes if f["case"] == f"prefill-{s}")
        run["flash"] = {k: fa[k] for k in ("ms", "bound_ms", "bound_by", "library_ms",
                                           "plain_group_ms", "max_abs_err", "bad_rows")}
        print(f"[long-static] {json.dumps(run)}")
        runs.append(run)
    model.__dict__.pop("_static_decoders", None)
    return {"runs": runs, "launches": total}


# ------------------------------------------------------------------ phase 8 --
def phase_long_continuous() -> dict:
    """Prompts past 2048 tokens through the continuous path at full width:
    LONG_REQUESTS seeded prompts of LONG_MIN..LONG_MAX tokens, graphed, its
    captures within the grid's bound, launches exact, drained; a timed
    rerun and a profiled window of LONG_WINDOW ticks (no eager rerun: phase
    4 holds graphed against eager); the static oracle's tokens, reported
    and not gated (random weights give near-flat logits)."""
    model = make_model(get_config(ARCH))
    reqs = seeded_requests(model.cfg.vocab, LONG_REQUESTS, LONG_MIN, LONG_MAX, NEW, 1, SEED)
    engine = ContinuousEngine(model, model.init(SEED, DEV), num_slots=SLOTS,
                              max_seq=required_max_seq(reqs), chunk=CHUNK, block_size=BLOCK,
                              device=DEV)
    first, launches, seconds = first_run("long", engine, reqs)
    stats = serve_stats(engine, seconds)
    replays = continuous_replays("long", engine, reqs, first, launches, eager=False,
                                 window=LONG_WINDOW)
    widest = max(engine.metrics()["horizon_buckets"])
    oracle = static_reference(model, engine.params, reqs, ServeConfig())
    model.__dict__.pop("_static_decoders", None)
    prefix = common_prefix(first, {r.id: oracle[r.id][r.prompt_len:] for r in reqs})
    res = {"requests": len(first), "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
           **stats, "launches": launches, **replays, "widest_bucket": widest,
           "chain_ranges_at_widest": attn_ops.chain_splits(SLOTS, model.cfg.n_kv_heads, widest,
                                                           torch.device(DEV))[0],
           "num_blocks": engine.pool.num_blocks, "kv_hbm_bytes": engine.pool.hbm_bytes(),
           "static_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}",
           "static_common_prefix_mean": float(np.mean(prefix))}
    print(f"[long] {json.dumps(res)}")
    return res


# ------------------------------------------------------------------ phase 9 --
# (read, KV dtype, eager rerun): the eager tick of the streamed fp read is
# held to its graphed run; the other two reuse its code under another arena
# or read, and their eager ticks (~0.1-0.2 s each) would cost ~40 s a run
READS = (("streamed", "fp", True), ("streamed", "int8", False), ("gathered", "fp", False))


def phase_reads(served: dict, int8: dict) -> dict:
    """Phase 4's workload and weights through the reference's two jnp paged
    reads (``FORCE_PAGED_READ``): streamed over the fp and the int8 pool,
    gathered over the fp pool, each graphed, with phase 4's gates (the
    softmax kernel launched a layer a tick in place of the paged read) and
    its replays (the eager rerun for the streamed fp read); tok/s, steady tick and busy share
    beside phases 4 and 6 (the kernel read), and the greedy prefix shared
    with phase 4's tokens (reported, not gated)."""
    model = make_model(get_config(ARCH))
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    master = model.init(SEED, DEV)
    res, total = {}, dict.fromkeys(counters.WRAPPERS, 0)
    for path, kv_dtype, eager in READS:
        label = f"reads-{path}-{kv_dtype}"
        with swapped("FORCE_PAGED_READ", path):
            engine = ContinuousEngine(model, master, num_slots=SLOTS,
                                      max_seq=required_max_seq(reqs), chunk=CHUNK,
                                      block_size=BLOCK, kv_dtype=kv_dtype, device=DEV)
            if engine.metrics()["read_path"] != path:
                fail(f"{label}: the engine reports {engine.metrics()['read_path']}")
            first, launches, seconds = first_run(label, engine, reqs)
            total = {k: total[k] + launches[k] for k in total}
            stats = serve_stats(engine, seconds)
            replays = continuous_replays(label, engine, reqs, first, launches, eager=eager,
                                         window=LONG_WINDOW)
        prefix = common_prefix(first, served["new_tokens"])
        res[label] = {**stats, "launches": launches, **replays,
                      "phase4_common_prefix_mean": float(np.mean(prefix)),
                      "phase4_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}"}
        print(f"[{label}] {json.dumps(res[label])}")
        del engine
        torch.cuda.empty_cache()
    keys = ("steady_tokens_per_s", "steady_mean_tick_ms", "device_busy_share")
    side = {"kernel-fp (phase 4)": {k: served[k] for k in keys},
            "kernel-int8 (phase 6)": {k: int8[k] for k in keys},
            **{label: {k: r[k] for k in keys} for label, r in res.items()}}
    print(f"[reads] {json.dumps(side)}")
    return {"runs": res, "launches": total}


# ----------------------------------------------------------------- phase 10 --
def guard_engine(model, master, reqs, **kw):
    return ContinuousEngine(model, master, num_slots=SLOTS, max_seq=required_max_seq(reqs),
                            chunk=CHUNK, block_size=BLOCK, device=DEV, **kw)


def sampler_check(vocab: int) -> dict:
    """The sampler at the tick's shape (SLOTS rows of the vocabulary): its
    hash words on the card bitwise the CPU's, and its device time."""
    streams = torch.arange(SLOTS) * 7 + 3
    pos = torch.arange(SLOTS) * 131 + 1000
    cpu = counter_bits(SEED, streams, pos, vocab)
    card = counter_bits(SEED, streams.to(DEV), pos.to(DEV), vocab)
    if not torch.equal(card.cpu(), cpu):
        fail("the sampler's hash words on the card differ from the CPU's")
    logits = torch.randn(SLOTS, vocab, generator=torch.Generator(device=DEV).manual_seed(4),
                         device=DEV)
    temps = torch.full((SLOTS,), GUARD_T, device=DEV)
    args = (logits, temps, SEED, streams.to(DEV), pos.to(DEV))
    return {"hash_bitwise_cpu": True, "rows": SLOTS, "vocab": vocab,
            "sample_ms": device_ms(lambda: sample(*args), 20),
            "argmax_ms": device_ms(lambda: logits.argmax(dim=-1), 20)}


def chaos_run(label: str, engine, reqs, kinds: tuple, clean: dict, leaves=None,
              gated: bool = True) -> dict:
    """A reset run of ``reqs`` with a fault injected every CHAOS_EVERY model
    ticks (CHAOS_FAULTS in all, ``kinds`` in turn), the ledger checked after
    every tick.  Gated: every fault flagged within one tick of its
    injection, every poisoned block quarantined, launches exact, every tick
    a replay, nothing plain on the card, the run drained.  Reported: each
    fault's detection latency (None: missed), and the requests whose tokens
    equal the fault-free run's ``clean``."""
    engine.reset()
    inj = FaultInjector(engine, seed=SEED, leaves=leaves)
    for req in reqs:
        engine.submit(req)
    torch.cuda.synchronize()
    counters.reset()
    records = []
    t0 = time.perf_counter()
    while engine.step():
        engine.pool.check_ledger()
        if (len(records) < CHAOS_FAULTS
                and engine.model_ticks >= CHAOS_EVERY * (len(records) + 1)):
            rec = inj.inject(kinds[len(records) % len(kinds)])
            if rec is not None:
                records.append(rec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = engine.metrics()
    latency = []
    for rec in records:
        flag = "fault_table_repair" if rec.kind == "table" else "fault"
        late = [e[1] - rec.step for e in engine.event_log if e[0] == flag and e[1] >= rec.step]
        latency.append(min(late) if late else None)
    toks = {c.request_id: c.new_tokens for c in engine.completions}
    reasons = [c.finish_reason for c in engine.completions]
    res = {"faults": [f"{r.kind}:{r.leaf or '-'}@{r.step}" for r in records],
           "latency_ticks": latency, "model_ticks": m["model_ticks"], "seconds": seconds,
           **{k: m[k] for k in ("sentinel_checks", "sentinel_violations", "quarantined_blocks",
                                "retries", "table_repairs", "failed_completions",
                                "preempt_resumes")},
           "finish_reasons": {r: reasons.count(r) for r in set(reasons)},
           "clean_identical": f"{sum(np.array_equal(toks.get(i), t) for i, t in clean.items())}"
                              f"/{len(clean)}"}
    print(f"[{label}] {json.dumps(res)}")
    if not gated:
        return res
    want = continuous_want(engine.model.cfg.n_layers, m["model_ticks"],
                           engine.pool.kv_dtype == "int8")
    missed = [f for f, lat in zip(res["faults"], latency) if lat is None or lat > 1]
    unquarantined = [r.block for r in records
                     if r.kind != "table" and r.block not in engine.pool.quarantined]
    if len(records) < CHAOS_FAULTS or missed or unquarantined:
        fail(f"{label}: {len(records)} faults, not flagged within a tick: {missed}, poisoned "
             f"blocks not quarantined: {unquarantined}")
    if counters.launch_counts() != want or any(counters.plain_cuda_calls().values()):
        fail(f"{label}: launches {counters.launch_counts()} != {want}, plain "
             f"{counters.plain_cuda_calls()}")
    if m["transfer_guarded_ticks"] != m["model_ticks"]:
        fail(f"{label}: {m['model_ticks'] - m['transfer_guarded_ticks']} ticks not replayed")
    if len(reasons) != len(reqs) or engine.pool.blocks_in_use or m["fallbacks"]:
        fail(f"{label}: not drained: {len(reasons)} of {len(reqs)} done, "
             f"{engine.pool.blocks_in_use} blocks held, {m['fallbacks']} fallbacks")
    return res


def phase_guard(served: dict, int8: dict) -> dict:
    """Sampling and the GN sentinels at full width, over phase 4's workload
    and weights (see the module docstring, phase 10)."""
    model = make_model(get_config(ARCH))
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    master = model.init(SEED, DEV)
    sampler = sampler_check(model.cfg.vocab)
    print(f"[guard-sampler] {json.dumps(sampler)}")
    # the sampled run, with phase 4's checks and a profiled window
    engine = guard_engine(model, master, reqs, cfg=ServeConfig(temperature=GUARD_T, seed=SEED))
    first, launches, seconds = first_run("guard-sampled", engine, reqs)
    stats = serve_stats(engine, seconds)
    replays = continuous_replays("guard-sampled", engine, reqs, first, launches,
                                 window=LONG_WINDOW)
    keys = ("steady_tokens_per_s", "steady_mean_tick_ms", "device_busy_share")
    prefix = common_prefix(first, served["new_tokens"])
    sampled = {"temperature": GUARD_T, **stats, "launches": launches, **replays,
               "greedy (phase 4)": {k: served[k] for k in keys},
               "greedy_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}"}
    print(f"[guard-sampled] {json.dumps(sampled)}")
    del engine
    # per pool: the sentinels' cost (greedy runs with them on and off, in
    # turns, tokens equal), then the chaos runs on the engine with them on
    cost, chaos = {}, {}
    for kv, before in (("fp", served), ("int8", int8)):
        on = guard_engine(model, master, reqs, kv_dtype=kv)
        off = guard_engine(model, master, reqs, kv_dtype=kv, sentinels=False)
        clean, _, _ = first_run(f"guard-on-{kv}", on, reqs)
        unguarded, _, _ = first_run(f"guard-off-{kv}", off, reqs)
        if any(not np.array_equal(t, unguarded[i]) for i, t in clean.items()):
            fail(f"the sentinels changed the greedy tokens over the {kv} pool")
        ticks = {"on": [], "off": []}
        for name, eng in (("on", on), ("off", off), ("off", off), ("on", on)):
            timed_run(eng, reqs)
            ticks[name].append(float(np.mean([dt * 1e3 for _, _, dt in eng.tick_log])))
        same = sum(np.array_equal(t, before["new_tokens"][i]) for i, t in clean.items())
        cost[kv] = {"tick_ms_on": ticks["on"], "tick_ms_off": ticks["off"],
                    "probe_ms_per_tick": float(np.mean(ticks["on"]) - np.mean(ticks["off"])),
                    "earlier_phase_identical": f"{same}/{len(clean)}"}
        print(f"[guard-cost-{kv}] {json.dumps(cost[kv])}")
        del off
        torch.cuda.empty_cache()
        chaos[kv] = chaos_run(f"guard-chaos-{kv}", on, reqs, CHAOS[kv], clean,
                              leaves=("v",) if kv == "fp" else None)
        if kv == "fp":  # K tiles: the read's per-row flag of a nonfinite score
            chaos["k_tiles"] = chaos_run("guard-chaos-k", on, reqs, ("nan_tile", "inf_tile"),
                                         clean, leaves=("k",))
        del on
        torch.cuda.empty_cache()
    res = {"sampler": sampler, "sampled": {k: sampled[k] for k in keys}, "cost": cost,
           "chaos": {k: {f: v[f] for f in ("latency_ticks", "clean_identical",
                                           "sentinel_violations", "quarantined_blocks")}
                     for k, v in chaos.items()}}
    print(f"[guard] {json.dumps(res)}")
    return {**res, "launches": launches}


# ----------------------------------------------------------------- phase 11 --
def train_want(layers: int, passes: int) -> dict:
    """The launches of ``passes`` forward + backward passes of the dense
    model: 2L + 1 norms a forward (2L - 1 fused), a flash attention a layer,
    and in the backward a GN softmax a layer (the flash backward's
    recompute; the norms' backward is plain torch)."""
    return {"gn_rmsnorm": (2 * layers + 1) * passes, "gn_rmsnorm_fused": (2 * layers - 1) * passes,
            "gn_paged_attention": 0, "gn_paged_attention_int8": 0, "gn_softmax": layers * passes,
            "gn_attention": layers * passes}


def train_batch(vocab: int) -> dict:
    return batch_at(DataConfig(vocab=vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                               seed=1234), 0)


def phase_train() -> dict:
    """Full-width, full-depth training: bf16 compute over f32 masters,
    TRAIN_STEPS AdamW steps of TRAIN_MB microbatches on one repeated batch.
    Gated: the launches exact, no plain version on the card, every loss and
    grad_norm finite, the loss falling every step.  Reported: ms a step (the
    first apart), tokens/s, peak memory, the device-busy share of a
    profiled step, and one microbatch's launches in forward and backward."""
    cfg = get_config(ARCH)
    model = make_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 2)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, DEV)
    state = init_opt_state(opt, params)
    batch = train_batch(cfg.vocab)
    step = make_train_step(model, opt, TRAIN_MB)
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    counters.reset()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    peak = torch.cuda.max_memory_allocated()
    want = train_want(cfg.n_layers, TRAIN_MB * TRAIN_STEPS)
    if launches != want or any(plain.values()):
        fail(f"train: launches {launches} != {want}, plain {plain}")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"train: nonfinite loss or grad_norm: {losses}, {norms}")
    if any(b >= a for a, b in zip(losses, losses[1:])):
        fail(f"train: the loss did not fall on a repeated batch: {losses}")
    _, prof, seconds = profiled(lambda: step(params, state, batch))
    busy = sum(_device_us(prof).values()) / 1e6
    # one microbatch's forward and backward, counted apart
    half = {"tokens": torch.as_tensor(batch["tokens"][:TRAIN_BATCH // TRAIN_MB]).to(DEV)}
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    counters.reset()
    loss, _ = model.loss(model.prepare(leaves, DEV), half)
    fwd = counters.launch_counts()
    counters.reset()
    torch.autograd.grad(loss, tree_leaves(leaves))
    torch.cuda.synchronize()
    bwd = counters.launch_counts()
    del leaves, loss
    steady = step_ms[1:]
    res = {"arch": ARCH, "layers": cfg.n_layers, "params": sum(t.numel() for t in
                                                               tree_leaves(params)),
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "microbatches": TRAIN_MB, "steps": TRAIN_STEPS,
           "compute_dtype": cfg.dtype, "losses": losses, "grad_norms": norms,
           "first_step_ms": step_ms[0], "step_ms": steady,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (float(np.mean(steady)) / 1e3),
           "peak_memory_bytes": peak, "profiled_step_s": seconds, "device_busy_s": busy,
           "device_busy_share": busy / seconds, "launches": launches,
           "microbatch_forward_launches": {k: v for k, v in fwd.items() if v},
           "microbatch_backward_launches": {k: v for k, v in bwd.items() if v},
           "top_kernels_s": dict(sorted(((k[:60], v / 1e6) for k, v in
                                         _device_us(prof).items()), key=lambda kv: -kv[1])[:8])}
    print(f"[train] {json.dumps(res)}")
    del params, state
    return res


# ----------------------------------------------------------------- phase 12 --
def phase_ckpt() -> dict:
    """Train the full widths cut to 2 layers for 3 steps (Adam moments held
    in bf16), save (params, opt_state), restore it, every leaf bitwise; serve
    8 requests through ContinuousEngine from the restored (params,) with the
    sentinels silent; then the launchers as a user runs them, on the card:
    ``launch.train --smoke --steps 3``, ``launch.serve --smoke --ckpt``, and
    the same training cut by ``--fail-at 2`` and resumed, whose step-3
    checkpoint is held against the uninterrupted run's (reported: on the
    card the embedding's backward sums with atomics, so the two may part
    in the last bits; the CPU test holds them bitwise)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    model = make_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=5, state_dtype="bfloat16")
    params = model.init(SEED, DEV)
    state = init_opt_state(opt, params)
    step = make_train_step(model, opt, TRAIN_MB)
    batch = train_batch(cfg.vocab)
    for _ in range(3):
        params, state, _ = step(params, state, batch)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = store.save(tmp / "ckpt", 3, (params, state), extra={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, man = store.restore(tmp / "ckpt", 3, (params, state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = store._flatten((params, state))
        back = store._flatten(restored)
        bad = [k for k in saved if back[k].dtype != saved[k].dtype
               or back[k].device != saved[k].device or not torch.equal(
                   back[k].reshape(-1).view(torch.uint8), saved[k].reshape(-1).view(torch.uint8))]
        if sorted(back) != sorted(saved) or bad:
            fail(f"ckpt: restored leaves differ from the saved ones: {bad[:5]}")
        dtypes = sorted(set(man["dtypes"].values()))
        (served_params,), _ = store.restore(tmp / "ckpt", 3, (params,))
        reqs = seeded_requests(cfg.vocab, 8, MIN_PROMPT, 256, 16, 1, SEED)
        engine = ContinuousEngine(model, served_params, num_slots=SLOTS,
                                  max_seq=required_max_seq(reqs), chunk=CHUNK, block_size=BLOCK,
                                  device=DEV)
        _, served_launches, serve_s = first_run("ckpt-serve", engine, reqs)
        del engine
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        env.pop("REPRO_FAIL_AT_STEP", None)
        launchers = {}
        train = ["repro_torch.launch.train", "--smoke", "--steps", "3"]
        cut = train + ["--checkpoint-every", "1", "--outdir", str(tmp / "cut")]
        for name, argv, want_rc in (
                ("train", train + ["--outdir", str(tmp / "smoke")], 0),
                ("serve", ["repro_torch.launch.serve", "--smoke", "--ckpt",
                           str(tmp / "smoke" / "ckpt"), "--batches", "1"], 0),
                ("train_fail_at_2", cut + ["--fail-at", "2"], 42),
                ("train_resume", cut, 0)):
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-m", *argv], env=env, cwd=ROOT, timeout=300,
                                 capture_output=True, text=True)
            launchers[name] = {"rc": run.returncode, "seconds": time.perf_counter() - t0,
                               "last_line": (run.stdout.strip().splitlines() or [""])[-1]}
            if run.returncode != want_rc:
                fail(f"ckpt: launch {name} exited {run.returncode}:\n{run.stdout[-2000:]}\n"
                     f"{run.stderr[-2000:]}")
            if name == "serve" and "restored checkpoint step 3" not in run.stdout:
                fail(f"ckpt: launch.serve did not restore the checkpoint:\n{run.stdout[-2000:]}")
            if name == "train_resume" and "[resume] from checkpoint step 2" not in run.stdout:
                fail(f"ckpt: the rerun did not resume from step 2:\n{run.stdout[-2000:]}")
        whole, _ = store.restore_flat(tmp / "smoke" / "ckpt", 3)
        resumed, _ = store.restore_flat(tmp / "cut" / "ckpt", 3)
        gaps = {k: (whole[k].double() - resumed[k].double()).abs().max().item() for k in whole}
        resume = {"leaves": len(gaps),
                  "bitwise_leaves": sum(torch.equal(whole[k], resumed[k]) for k in whole),
                  "max_abs_gap": max(gaps.values()),
                  "gap_leaves": sorted(k for k, g in gaps.items() if g)[:8]}
        res = {"layers": cfg.n_layers, "leaves": len(saved), "dtypes": dtypes,
               "bytes": (path / "arrays.npz").stat().st_size, "save_s": save_s,
               "restore_s": restore_s, "bitwise": True, "serve_requests": len(reqs),
               "serve_s": serve_s, "serve_launches": served_launches, "launchers": launchers,
               "resume_vs_uninterrupted": resume}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[ckpt] {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 13 --
def phase_table1(root: Path) -> dict:
    """The Table I analogue on the card: the tiny gpt-neo backbone trained
    TABLE1_STEPS steps with exact ops (its checkpoint under ``root``, which
    phase 14 reads), evaluated with the same weights under (exact,
    exact_ln), (gn, gn_ln) and (gn_hwsim, gn_ln_hwsim): each row's
    perplexity and top-1, its change in percent, the training's wall
    seconds.  Gated: finite rows, and the GN row's launches exact (the
    exact and hwsim rows and the exact training launch no GN kernel)."""
    counters.reset()
    out = table1_accuracy.run(steps=TABLE1_STEPS, device=DEV, root=root)
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    layers, batches = tiny_cfg().n_layers, 4
    # the GN row's forward over the held-out batches: train_want's forward
    want = {**train_want(layers, batches), "gn_softmax": 0}
    if launches != want or any(plain.values()):
        fail(f"table1: launches {launches} != {want}, plain {plain}")
    rows = {k: out[k] for k in table1_accuracy.ROWS}
    if not all(math.isfinite(m["perplexity"]) and 0 <= m["top1_acc"] <= 1 for m in rows.values()):
        fail(f"table1: rows not finite: {rows}")
    res = {**rows, "train_seconds": out["train_seconds"], "steps": out["steps"],
           "launches": launches}
    print(f"[table1] {json.dumps(res)}")
    return res


# ----------------------------------------------------------------- phase 14 --
# Table I's GN rows against FP32 on the tiny backbone, perplexity change in %
TABLE1_PPL_PCT = 0.1
# full width: gpt-neo-1.3b (the paper's perplexity backbone) in bf16, random
# weights from SEED, perplexity over TABLES_BATCH x TABLES_SEQ Zipf-chain
# tokens under each pair; card against CPU over TABLES_ROWS sampled rows
TABLES_ARCH, TABLES_BATCH, TABLES_SEQ, TABLES_ROWS = "gpt-neo-1.3b", 4, 1024, 2048
FULL_PAIRS = {"FP32": ("exact", "exact_ln"), **table2_score_tasks.METHODS,
              "FP32+Ours(hwsim)": ("gn_hwsim", "gn_ln_hwsim")}
# card against CPU: name -> (atol relative to the row's largest |output|, the
# share of rows allowed past it, the largest gap any row may show relative
# to that scale).  The baselines' are those the CPU tests hold them to
# against the JAX package (baselines.PARITY_TOL: one ulp of an exponential or
# a sum in another order moves a floor quantizer one step or a row 2x); the
# float functions agree to a few f32 roundings; the hwsim is bitwise
CARD_TOL = {"exact": (1e-6, 0.0, 0.0), "gn": (1e-6, 0.0, 0.0), "gn_hwsim": (0.0, 0.0, 0.0),
            "exact_ln": (1e-6, 0.0, 0.0), "gn_ln": (1e-6, 0.0, 0.0),
            "gn_ln_hwsim": (0.0, 0.0, 0.0), "exact_rms": (1e-6, 0.0, 0.0),
            "gn_rms": (1e-6, 0.0, 0.0), **baselines.PARITY_TOL}


def card_against_cpu(name: str, fn, rows) -> dict:
    """``fn`` on the card and on the CPU over the same f32 rows: bitwise, or
    the share of rows past CARD_TOL[name] and the largest gap."""
    got, want = fn(rows).float().cpu(), fn(rows.cpu()).float()
    atol, budget, step = CARD_TOL[name]
    bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
    gap = (got.double() - want.double()).abs().amax(dim=-1)
    rel = gap / want.double().abs().amax(dim=-1).clamp_min(1e-30)
    res = {"bitwise": bitwise, "rows_past": float((rel > atol).double().mean()),
           "max_rel": float(rel.max()), "max_abs_err": float(gap.max())}
    must_be_bitwise = atol == 0.0 and step == 0.0
    if not bitwise and (must_be_bitwise or res["rows_past"] > budget
                        or res["max_rel"] > max(atol, step)):
        fail(f"tables: {name} on the card against the CPU: {res}, tolerance {CARD_TOL[name]}")
    return res


def tables_tiny(root: Path, table1: dict) -> dict:
    """(a) On the tiny backbone phase 13 trained (its checkpoint under
    ``root``): Table I's rows from phase 13, Table II, Fig. 5, the Fig. 2
    sweep and the study's paged reads, Table III.  Gated: every row finite,
    the GN rows of Table I within TABLE1_PPL_PCT of FP32, the GN rows' Fig. 5
    errors below fig5_norm_error.GN_EDGES, the paged reads within their
    analytic bound."""
    t1 = {k: table1[k] for k in table1_accuracy.ROWS}
    print(f"[tables-table1] {json.dumps(t1)}")
    for label in ("FP32+Ours", "FP32+Ours(hwsim)"):
        if not abs(t1[label]["ppl_delta_%"]) <= TABLE1_PPL_PCT:
            fail(f"tables: Table I {label} perplexity {t1[label]['ppl_delta_%']:+.4f}% of FP32, "
                 f"past {TABLE1_PPL_PCT}%")
    t2 = table2_score_tasks.run(steps=TABLE1_STEPS, device=DEV, root=root)
    print(f"[tables-table2] {json.dumps(t2)}")
    if not all(math.isfinite(m["perplexity"]) and 0 <= m["top1_acc"] <= 1 for m in t2.values()):
        fail(f"tables: Table II rows not finite: {t2}")
    f5 = fig5_norm_error.run(steps=TABLE1_STEPS, device=DEV, root=root)
    print(f"[tables-fig5] {json.dumps(f5)}")
    for fam, edges in fig5_norm_error.GN_EDGES.items():
        for name, edge in edges.items():
            if not f5[fam][name]["max"] < edge:
                fail(f"tables: Fig. 5 {fam}/{name} max error {f5[fam][name]['max']} >= {edge}")
    study = norm_error_study.run(device=DEV)
    print(f"[tables-fig2] {json.dumps(study)}")
    if not all(r["ok"] for r in study["paged"].values()):
        fail(f"tables: the paged reads' Σp past their bound: {study['paged']}")
    t3 = table3_hw_cost.run(device=DEV, root=root)
    print(f"[tables-table3] {json.dumps({k: {c: v for c, v in m.items() if c != 'ops'} for k, m in t3.items()})}")
    return {"table1": t1, "table2": t2, "fig5": f5, "study": study, "table3": t3}


def tables_full_width() -> tuple[dict, dict, dict]:
    """(b) Full-width gpt-neo-1.3b in bf16, random weights from SEED:
    ``perplexity`` over TABLES_BATCH x TABLES_SEQ tokens under every pair of
    FULL_PAIRS, each the ms of a forward (after a warm-up), the peak device
    memory and the (random-weight, finiteness-only) perplexity.  Gated: the
    GN kernels launched only in the (gn, gn_ln) row, exactly its forward's;
    no plain version on the card.  (c) Layer 0's score rows (causal) and the
    pre-norm rows captured on the card; TABLES_ROWS of each sampled through
    every name of get_softmax and get_norm on the card and on the CPU
    (card_against_cpu), each name's ms over all the rows, the hwsim loops'
    ms at these shapes, and Fig. 5's fractions over the sampled rows."""
    cfg = get_config(TABLES_ARCH)
    base = make_model(cfg)
    master = base.init(SEED, DEV)
    params = base.prepare(master, DEV)
    tokens = torch.as_tensor(batch_at(DataConfig(vocab=cfg.vocab, seq_len=TABLES_SEQ,
                                                 global_batch=TABLES_BATCH, seed=SEED), 0)
                             ["tokens"]).to(DEV)
    layers = cfg.n_layers
    gn_want = {**train_want(layers, 1), "gn_softmax": 0}
    rows = {}
    for label, (sm, nm) in FULL_PAIRS.items():
        model = make_model(dataclasses.replace(cfg, softmax_impl=sm, norm_impl=nm))
        before, plain0 = counters.launch_counts(), counters.plain_cuda_calls()
        with torch.no_grad():
            perplexity(model, params, {"tokens": tokens})  # warm-up
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()  # weights, f32 masters, tokens
            ppl, ms = timed(lambda: perplexity(model, params, {"tokens": tokens}))
        peak = torch.cuda.max_memory_allocated()
        after, plain1 = counters.launch_counts(), counters.plain_cuda_calls()
        launches = {k: after[k] - before[k] for k in after}
        want = ({k: 2 * v for k, v in gn_want.items()} if (sm, nm) == ("gn", "gn_ln")
                else dict.fromkeys(after, 0))
        if launches != want or plain1 != plain0:
            fail(f"tables: {label} ({sm}, {nm}) launches {launches} != {want}, plain "
                 f"{plain0} -> {plain1}")
        if not math.isfinite(ppl):
            fail(f"tables: {label} perplexity {ppl} at full width")
        rows[label] = {"impls": [sm, nm], "forward_ms": ms, "peak_memory_bytes": peak,
                       "forward_peak_over_resident_bytes": peak - resident, "perplexity": ppl, "launches": {k: v for k, v in launches.items() if v}}
    rows["hwsim_over_gn"] = (rows["FP32+Ours(hwsim)"]["forward_ms"]
                             / rows["Proposed(GN)"]["forward_ms"])
    print(f"[tables-fullwidth] {json.dumps({'arch': TABLES_ARCH, 'dtype': cfg.dtype, 'batch': [TABLES_BATCH, TABLES_SEQ], **rows})}")
    del params
    # (c) layer 0's inputs at this width, from the f32 masters
    scores, acts = fig5_norm_error.collect_attention_inputs(cfg, master, [tokens])
    del master
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    pick = (lambda x: x[torch.randperm(x.shape[0], generator=gen, device=DEV)[:TABLES_ROWS]
                        .sort().values])
    s_rows, a_rows = pick(scores), pick(acts)
    card, ms = {}, {}
    for name in CARD_TOL:
        fn, full = ((get_softmax(name), scores) if name in fig5_norm_error.SOFTMAXES
                    else (get_norm(name), acts))
        card[name] = card_against_cpu(name, fn, s_rows if full is scores else a_rows)
        ms[name] = call_ms(lambda: fn(full), 3, warmup=1)
    z = torch.randint(1 << 15, 1 << 22, (scores.shape[0], 1), generator=gen, device=DEV)
    var = torch.randint(1, 1 << 30, (acts.shape[0], 1), generator=gen, device=DEV)
    loops = {"shift_subtract_div_ms": call_ms(lambda: shift_subtract_div(1 << 15, z, 24), 3, 1),
             "shift_subtract_div_rows": z.shape[0],
             "lod_ms": call_ms(lambda: lod(var), 3, 1), "lod_rows": var.shape[0]}
    fractions = fig5_norm_error.histograms(s_rows, a_rows)
    out = {"score_rows": list(scores.shape), "norm_rows": list(acts.shape),
           "sampled": TABLES_ROWS, "card_vs_cpu": card, "ms_all_rows": ms, "hwsim_loops": loops,
           "fig5_frac_below_0.2e-6": {fam: {k: h["frac_below_0.2e-6"] for k, h in d.items()}
                                      for fam, d in fractions.items()}}
    print(f"[tables-card-vs-cpu] {json.dumps(out)}")
    return rows, out


def phase_tables(root: Path, table1: dict) -> dict:
    """The paper's comparison path: (a) the tables on the tiny backbone,
    (b) the pairs' forwards at full width, (c) every name on the card
    against the CPU at full-width shapes."""
    counters.reset()
    tiny = tables_tiny(root, table1)
    full, card = tables_full_width()
    launches = counters.launch_counts()
    res = {"launches": launches,
           "table1_fig5_frac_below_0.2e-6": {fam: {k: h["frac_below_0.2e-6"] for k, h in d.items()}
                                             for fam, d in tiny["fig5"].items()},
           "full_width_fig5_frac_below_0.2e-6": card["fig5_frac_below_0.2e-6"],
           "hwsim_over_gn": full["hwsim_over_gn"]}
    print(f"[tables] {json.dumps(res)}")
    return res


SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "gn_rmsnorm": ("src/repro_torch/csrc/gn_layernorm.cu",
                   "src/repro/kernels/gn_layernorm/kernel.py:81"),
    # the same kernel's fused entry: the residual add, then the norm
    "gn_rmsnorm_fused": ("src/repro_torch/csrc/gn_layernorm.cu",
                         "src/repro/kernels/gn_layernorm/kernel.py:81"),
    "gn_paged_attention": ("src/repro_torch/csrc/gn_paged_attention.cu",
                           "src/repro/kernels/gn_paged_attention/kernel.py:160"),
    "gn_paged_attention_int8": ("src/repro_torch/csrc/gn_paged_attention.cu",
                                "src/repro/kernels/gn_paged_attention/kernel.py:97-104"),
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
    seconds = {}

    def phase(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - start, 1)
        return out

    card = phase("build", phase_build)
    kern = phase("kernels", phase_kernels)
    phase("parity", phase_parity)
    served = phase("serve", phase_serve)
    static = phase("static", phase_static)
    int8 = phase("int8", phase_int8, served)
    long_static = phase("long-static", phase_long_static, kern["gn_attention"])
    long_cont = phase("long", phase_long_continuous)
    reads = phase("reads", phase_reads, served, int8)
    guard = phase("guard", phase_guard, served, int8)
    train = phase("train", phase_train)
    phase("ckpt", phase_ckpt)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tables_"))  # phases 13 and 14
    try:
        table1 = phase("table1", phase_table1, root)
        tables = phase("tables", phase_tables, root, table1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path = {"continuous": served["launches"], "static": static["launches"],
               "int8": int8["launches"], "long_static": long_static["launches"],
               "long_continuous": long_cont["launches"], "reads": reads["launches"],
               "sampled": guard["launches"], "train": train["launches"],
               "table1": table1["launches"], "tables": tables["launches"]}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        # the main path's shape: bf16 tick (fp or int8 KV; the norms' 128
        # rows), f32 prefill rows, bf16 forward
        main_case = kern[name][0]
        counts = {path: n[name] for path, n in by_path.items() if n[name]}
        design = {key: main_case[key] for key in ("design", "layout") if key in main_case}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces, **design,
            "launches": sum(counts.values()), "launches_by_path": counts,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": main_case["shape"],
            "dtype": main_case["dtype"],
        })
    print(f"[total] {time.perf_counter() - t0:.1f}s on {card}; per phase (s): "
          f"{json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
