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
               attention in both designs (f32, bf16); the paged read over the
               prefix cache's tables (six lanes sharing 72 leading blocks, a
               forked partial tail block), fp and int8 mode; for phases 17
               and 18 the paged read at llama4-scout's group of 5 (40 q over
               8 kv heads; C = 16 on the CUDA-core design, C = 1 on the
               tensor cores; fp and int8), the norm at widths 256, 768, 2560
               and 5120, and the softmax over 16-column router rows and over
               an MLA tick's 40-head score rows; for phase 19 the flash
               attention with a sliding window (``window-*``: mixtral's
               prefill (1, 48, 8, 8192, 128) at window 4096 on the tensor
               cores, its first kv head's group held against the plain
               version, times beside the banded bound, the causal call and
               SDPA under the band as a boolean mask; a ragged KV-prefix
               bf16 case and an f32 case on the CUDA cores; exact scores,
               V = 1, and a window past Sk bitwise the causal call) and the
               softmax over the slab tick's rows (``slab-tick``: 8 slots x 48
               heads x 16 lanes over the 4096-slot ring + 16); for phases 21
               and 22 the flash attention non-causal at whisper's encoder
               (``whisper-encoder``: (8, 20, 1500, 64), ragged) and at
               MLA's padded head dim past 2048 (``mla-4096``: (1, 40, 4096,
               96), v of 64 zero-padded, the padded columns exactly 0), the
               softmax over cross-attention rows (``xattn-whisper``: 1500
               columns, ``xattn-vlm``: 1601), and the norm at whisper's
               1280 (LayerNorm) and the VLM's 4096 (RMS); for phase 23 the
               flash attention at zamba2's forward (``zamba2-forward``:
               (8, 32, 1024, 112) causal, the head dim inside the 128
               instantiation, its ragged D edge masked; exact scores, V = 1),
               the softmax over zamba2's slab-tick rows (``zamba2-slab-tick``:
               8 slots x 32 heads x 16 lanes over 1056 slab slots) and its
               decode rows (``zamba2-decode``), and the norm at xlstm's 1024
               (LayerNorm) and its mixer's 2048 (RMS, no gamma), zamba2's
               3584 and its mixer's 7168 (RMS); the softmax's fused score
               entry (``fused-*``, first: the static prefill's is the main
               path's call) at each call site's shape, bf16 as served and the
               slab tick at f32, bit for bit the chain it replaces (scale,
               cast, mask, the softmax kernel, cast), its time beside the
               chain's five launches and its 4-bytes-an-element bound, and
               (``site-trace``) the static prefill's ``_sdpa`` traced: one
               softmax launch with nothing before it but the score
               product's own kernels;
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
               checks (a profiled window of LONG_WINDOW ticks); their tok/s, tick and
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
               --smoke --ckpt`` as subprocesses on the card; every launcher
               subprocess of the script starts here, in chains that run
               side by side (``LAUNCH_CHAINS``: train then serve, the cut
               run then its resume, phase 21's and phase 23's), and phases
               21 and 23 gate theirs where they stand;
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
 15. prefix  - chat behind one system prompt at full width (phase 4's model, 8
               slots, chunk 16, block 16): 32 users over a 1024-token system
               prompt, 4 personas of 128 and a 64-token turn, 32 new tokens,
               an arrival every 2 ticks; the prefix cache off and on (fp
               pool), on over the int8 pool, on over a tight arena of 5
               footprints.  Gated: launches exact in every run, every fork
               read back bitwise its source (arenas and scales), captures
               within the bucket grid, a reset rerun's tokens equal, the
               cache-on run's eager tick bitwise the graphed one (with a
               profiled window), the ledger balanced and evictions in the
               tight run; at 2 layers and f32 the greedy tokens with the
               cache on equal those with it off (fp, int8).  Reported: tok/s
               and tick (first run, steady), TTFT in steps and ms, hit rate,
               forks, evictions, cached blocks, each request's greedy prefix
               shared with the cache-off run;
 16. sla     - interactive and batch traffic at full width: 48 requests of
               ``sla_requests`` (base 256 tokens, 16 / 128 new) over an
               arena of 160 blocks, FCFS, priority + recompute, priority +
               spill (fp and int8) and priority + spill with a shedding
               watermark.  Gated: launches exact, every request completed
               with its budget or rejected while of class batch and never
               admitted, every spill and restore read back bitwise (arenas,
               scales, the held-logits row), the shedding run's eager tick
               bitwise the graphed one, a reset rerun of each engine's first
               run equal; at 2 layers and f32 the preempted requests' tokens
               equal the preempt-off priority run's (recompute, spill).  The
               fp runs share one engine (its graphs), the policy set between
               runs.
               Reported: TTFT p50/p99 per class in steps and ms, tok/s,
               preemptions, resumes, rejections, spill bytes.
 17. mla     - minicpm3-4b (MLA: latent arenas c_kv 256 and k_rope 32 a
               token, read through the streamed read and the GN softmax
               kernel, both latents normed by the GN norm kernel) at full
               width cut to MLA_LAYERS of its 62 layers (since phase 23 joined
               the script: the time limit), random weights, phase 4's
               workload: the
               continuous path over the fp and the int8 latent pool (each
               with launches exact, captures within the grid, a timed
               rerun, and a rerun in which every captured graph's first
               tick runs graphed and eager from one device state, bitwise,
               and ticks FAMILY_START.. are traced: busy share, busy time
               by kind of kernel, the GN kernels' records) and a chaos run
               over each (a NaN latent tile, a corrupt scale; flagged within
               one tick, quarantined), the sentinels' cost a tick (the
               window's ticks with them off), the prefix cache over phase
               15's chat workload (forks bitwise, hits), ``generate`` over 8 x 1024
               tokens with 32 new and ``perplexity`` (launches exact); the
               pool's bytes a token beside phase 4's; at 2 layers f32 the
               engine's tokens equal the static oracle's and the CPU engine's
               (gated);
 18. moe     - llama4-scout-17b-a16e (16 experts, top-1 GShard routing
               through the GN softmax kernel, 40 q / 8 kv heads: the paged
               read at a group of 5) at full width cut to MOE_LAYERS layers,
               phase 4's workload over the fp pool through the kernel read
               with phase 4's checks; the routing of the eager rerun per
               tick kind (dropped share, expert load); the paged read's
               design and device ms at group 5 from phase 2; ``generate`` and
               the flash-kernel ``perplexity`` (launches exact); at 2 layers
               f32 the card's engine tokens equal the CPU engine's on the
               streamed read (gated).
 19. slab    - the slab pool (``ContinuousEngine(paged=False)``, one slab or
               ring a slot, a graph a step kind): (a) full-width
               internlm2-1.8b over phase 4's workload (launches exact, every
               tick a replay, a timed rerun, then a rerun in which each
               captured graph's first tick runs graphed and eager from one
               device state, bitwise, and ticks FAMILY_START.. are traced:
               busy share, busy time by kind); its bytes beside phase 4's
               pool; (b) mixtral-8x22b at full width cut to MIXTRAL_LAYERS
               of 56 layers (its window 4096, 8 experts top-2), 12 prompts
               of 3584..6144 tokens (rings wrapped), 32 new, with (a)'s
               checks and the MoE's dropped share per tick kind, then its
               static path past the window (the windowed flash kernel in
               prefill; launches exact); (c) at 2 layers f32 (full widths)
               the slab engine against the static oracle, the paged engine
               and the CPU's slab engine (gated; mixtral with its window cut
               to 64: card = CPU gated, the oracle reported, as the MoE's
               chunked prefill routes in other groups);
 20. snapshot - ``engine.snapshot``/``restore``: (a) at 2 layers f32 a
               writer snapshots after every tick and one restorer whose
               graphs a run captured restores each snapshot and drains,
               bitwise the writer (completions, finish steps, event log,
               step count), over the paged fp, paged int8 and slab pools;
               (b) full-width internlm2-1.8b over phase 4's workload,
               snapshots at model ticks SNAP_TICKS restored into one fresh
               engine and drained: tokens bitwise phase 4's, the drains'
               launches exact, bytes, save and restore seconds; (c) a chaos
               snapshot with a quarantined block restores it quarantined,
               the ledger balanced through the drain; (d) whisper at 2
               layers f32 (encoder too) with each request's frames:
               snapshots at model ticks SNAP_EXTRAS_TICKS (the frames and
               the pool's cross k/v in them) drained bitwise.
 21. long-chunked - past 2048 tokens: (a) internlm2-1.8b uncut with the
               exact softmax, static prefill and forward at LONG_EXACT
               through the chunked stream (launches exact: the norms only;
               ms, peak memory), and its forward at 1 x 4096 against the
               one-pass forward (f32 gated, bf16 reported); (b) minicpm3-4b
               uncut, ``generate`` over MLA_LONG with NEW new tokens (the
               prefill's flash launches at the padded head dim) and
               ``perplexity`` (launches exact); (c) training at TRAIN_LONG
               (full depth; the straight-through backward, no softmax
               launch past 2048; step ms, tokens/s, peak memory) and
               ``launch.train --smoke --seq 4096`` as a subprocess (started
               in phase 12); (d) at 2 layers f32 card = CPU: prefill logits
               (GN and exact) and the flash kernel's straight-through
               gradients, the card's half first and the CPU's in a thread
               beside (a)-(c).
 22. cross   - whisper-large-v3 and llama-3.2-vision-11b at full width cut
               to a sixteenth and an eighth of their depth (XATTN_DEPTH:
               whisper 2 + 2 of 32 + 32 layers, the VLM 5 of 40 in 1 block;
               the time limit; random weights, VLM gates
               XATTN_GATE), phase 4's
               workload, each request with seeded frames or patches: the
               paged fp pool with phase 17's lean checks (launches exact,
               the encoder's an admission counted in; every captured
               graph's first tick bitwise its eager tick; a traced window),
               the int8 and slab pools (launches exact, timed reruns), the
               static path (8 x 1024 + 32, launches exact) and the
               encoder's ms an admission, ``hbm_bytes()`` with the cross
               k/v or patches; at 2 layers f32 (whisper's encoder at 2, the
               VLM at one block over XATTN_SMALL_PATCHES patches) engine =
               static oracle = CPU over the paged and the slab pool
               (gated).
 23. ssm     - xlstm-350m (24 mLSTM layers, d_model 1024, 4 heads of 512:
               C (8, 4, 512, 512) f32 a layer) and zamba2-7b (81 Mamba2
               layers in 9 groups, each behind one weight-shared attention +
               MLP block; d_model 3584, 32 heads of 112) at full width, cut
               to SSM_DEPTH layers (3 and 9: 1 group; the time limit),
               bf16, random weights from a seed (``layerwise_master``),
               phase 4's workload over the slab pool (they do not page):
               phase 17's lean checks (launches exact, a tick's as
               ``recurrent_want``; every tick a replay; a timed rerun; a
               rerun in which each captured graph's first tick runs graphed
               and eager, bitwise, and ticks FAMILY_START.. are traced: busy
               share, busy time by kind), ``hbm_bytes()`` (the carries, and
               zamba2's shared K/V a group); the static path (``generate``
               8 x 1024 + 32 and ``perplexity``, launches exact: the one-pass
               softmax in prefill and decode, the flash kernel in the
               forward), and the engine over the static path's prompts, each
               request's common prefix with ``generate``'s (reported: the
               static prefill of 1024 takes the chunked forms); at f32 on 2
               layers (zamba2 at full width in 2 groups of 2) engine = static
               oracle = CPU (gated) and snapshots at model ticks
               SNAP_EXTRAS_TICKS drained bitwise; training at 4 x 1024 in 2
               microbatches (xlstm full depth, zamba2 cut to one group of 9
               layers: AdamW's f32 state of 6.75e9 parameters does not fit;
               launches exact, losses finite, the trained forward causal),
               and ``launch.train --arch xlstm-350m --smoke`` as a
               subprocess (started in phase 12).
 24. audit   - run right after phase 6, on its engine and phase 4's (nothing
               is built; both dropped after): ``repro_torch.analysis``'s
               audit (``[audit]``): the trace keys against the captures, and
               one eager call of each entry point under the op recorder (the
               tick at every captured (step kind, bucket), every lane
               parked; the sentinel step; the prefix fork), every audit rule
               on each, at full width over fp and int8 arenas; the
               self-check of every rule's fixtures; then (``[roofline]``)
               ``launch.profile_cell``'s core over phase 4's steady ticks:
               one eager tick's work (``roofline.op_cost``, each GN kernel's
               ``work()``), a profiled window of LONG_WINDOW replayed ticks
               (taken again until its trace holds every GN kernel's
               records) with each GN kernel's device time beside its bound,
               and exactly one device-to-host copy a replayed tick.
 25. sharded - (``[sharded]``) phase 4's workload and weights through
               ``ContinuousEngine(devices=2)``: full-width internlm2-1.8b,
               bf16, fp paged, sentinels on, on two cards where the machine
               has them, else as two shards of cuda:0 (the line names which);
               every request done, launches exact (each shard's tick launches
               a one-device tick's kernels), one graph a shard a key, a timed
               rerun of replays (tok/s, tick ms, ``shard_balance``,
               ``device_admits``), a profiled window of LONG_WINDOW replayed
               ticks (busy share; exactly one device-to-host copy a shard a
               tick: ``audit.dtoh_budget``; a trace that lost records is
               taken again, up to AUDIT_TRACES times, each one's count
               reported), a rerun in which every shard's
               first replay of each captured graph is held bitwise against
               its eager tick (``checked_graphs``), the first
               SHARD_PROBE_TICKS ticks in lockstep with a one-device engine
               (held logits within SHARD_LOGIT_RTOL of the row's largest
               |logit|, gated; the top-1/top-2 gaps reported), and the share
               of greedy tokens that agree with phase 4's one-device run
               (reported); then at
               f32 on 2 layers (gated): the two-shard engine's tokens equal
               the one-device engine's and ``static_reference``'s on the
               card, and a ``device_loss`` injection is logged
               (``device_lost``), its range quarantined, and every request
               completes with the static oracle's tokens; then
               (``[sharded-moe]``) llama4-scout at phase 18's 4 layers, f32,
               over two slots, one a shard: the shards tick in lockstep
               (one GShard group a tick across them, eager; gated), on the
               streamed and on the kernel read, in step with one eager
               device on the streamed read (``moe_in_step``): each tick the
               shards route alike and place every token as one device does
               (gated); up to the first routing or token difference every
               router logit of a live lane and every held logits row within
               MOE_RTOL of one device's, and at a routing difference that
               layer's router logits too (gated; the difference, the ticks
               compared and each read's share of one device's new tokens
               reported); every request one device's tokens where no
               difference came (gated); the kernel read's whole sequences
               keep the reference's MoE pin against ``static_reference``
               (gated); each engine's tick ms reported; one device's
               kernel-read and streamed-read engines share every token up to
               their first parting, and there each slot whose greedy pick
               differs holds logits within MOE_RTOL of the other read's (a
               near-tie, ``reads_apart``; gated).
 26. sharded-train - (``[sharded-train]``) phase 11's full-width training
               (its weights, batch, optimizer and microbatches) under an NCCL
               group of one rank on a (1, 1) (data, model) mesh, every leaf a
               DTensor and every kernel on local shards: 3 steps whose
               launches equal phase 11's and whose losses stay within 1e-5
               relative of phase 11's (gated), the step ms beside phase 11's
               and the card's name and power limit; the reduced config saved
               after a step on the mesh, ``restore_sharded`` and a second
               step equal to the unsharded second step within 1e-5 (gated); where the machine has n >= 2 cards also (1, n)
               and (n, 1) meshes, one NCCL rank a card (losses finite and
               falling, gated; the gap to phase 11's reported); the (1, 1)
               run's parameter, AdamW state and batch bytes and its peak
               allocation above what was there before (phase 27 reads them).
 27. dryrun  - (``[dryrun]``) ``launch.dryrun`` on the card's torch, over
               fake tensors of device cuda (nothing allocated, nothing
               launched): (a) DRYRUN_CELLS (internlm2-1.8b train_4k,
               prefill_32k and decode_32k on pod16x16 and train_4k on
               pod2x16x16; llama4-scout train_4k; zamba2-7b long_500k under
               SP_OVERRIDES; minicpm3-4b decode_32k, MLA through
               ``local_mixer``) at DRYRUN_DEPTH layers: every cell ok and the
               launch and plain-version counters unmoved (gated); each
               cell's seconds, memory, collective bytes by kind and
               roofline; (b) the dry run of phase 26's own step (its config,
               batch, optimizer and microbatches on a (1, 1) mesh): argument
               bytes equal to phase 26's exactly, no collective bytes, and
               argument + temp within DRYRUN_MEM_RTOL of phase 26's peak
               (gated); its roofline terms beside phase 26's step ms.
Every bound in the script is the roofline module's (``roofline.analysis``,
one copy of the H100 peaks) over a kernel wrapper's ``work()``.
Phases 4-10 and 15-18 serve with the GN sentinels on, the engine's default:
a tick launches one more norm, the head's σ probe.
Each path's launch counters are set to 0 just before it runs and read just
after.  The last two lines are the kernels JSON and {"ok": true, ...}.

Usage: python3 chip_smoke.py   (needs one CUDA GPU and nvcc)
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import gc
import json
import math
import os
import re
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

from repro_torch.analysis import audit, tracekeys  # noqa: E402
from repro_torch.analysis.__main__ import run_self_check  # noqa: E402
from repro_torch.benchmarks import (fig5_norm_error, norm_error_study,  # noqa: E402
                                    table1_accuracy, table2_score_tasks, table3_hw_cost)
from repro_torch.benchmarks.common import tiny_cfg  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.registry import get_config, reduce_config  # noqa: E402
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
from repro_torch.launch import profile_cell  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.layers import make_param  # noqa: E402
from repro_torch.models.transformer import make_model  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.serve.engine import (ContinuousEngine, ServeConfig, generate,  # noqa: E402
                                      perplexity, static_decoder, static_reference)
from repro_torch.serve.faults import FaultInjector  # noqa: E402
from repro_torch.serve.sampling import counter_bits, sample  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.serve.workload import (required_max_seq, seeded_requests,  # noqa: E402
                                        shared_prefix_requests, sla_requests)
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,  # noqa: E402
                                         tree_leaves, tree_map)

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
# ticks of the long continuous rerun (and phases 6, 9, 10, 15, 16, 24, 25)
# that are profiled: the profiler's host time grows with the window's kernel
# records (64 ticks took the script to ~1060 s on an H100, 16 to 1373 s on a
# slow host with phases 25's MoE case and 26), so 8 keep it inside its limit
LONG_WINDOW = 8
# phase 10: the sampled run's temperature; the chaos runs inject a fault every
# CHAOS_EVERY model ticks, CHAOS_FAULTS in all, drawn in turn from each
# pool's kinds (V tiles on the fp pool; K tiles, flagged by the paged
# kernel's per-row flag of a nonfinite score, in a run of their own)
GUARD_T = 0.7
CHAOS_EVERY, CHAOS_FAULTS = 10, 9
CHAOS = {"fp": ("nan_tile", "inf_tile", "table"), "int8": ("scale", "table")}
# phase 15: chat behind one system prompt (a 1024-token system prompt, 4
# personas of 128, a user turn of 64, 32 new tokens, an arrival every 2
# ticks); the tight run's arena holds PREFIX_TIGHT full footprints
PREFIX = {"n_users": 32, "n_personas": 4, "system_len": 1024, "persona_len": 128,
          "user_len": 64, "max_new_tokens": 32, "stagger": 2}
PREFIX_TIGHT = 5
# phase 16: interactive and batch traffic on one card (the reference's rate
# and bursts) over an arena of SLA_BLOCKS blocks (four 640-token
# footprints), so that interactive heads must preempt; the shedding run's
# watermark, in blocks (two arenas of backlog)
SLA = {"n_requests": 48, "base_len": 256, "max_new_interactive": 16, "max_new_batch": 128}
SLA_BLOCKS, SLA_SHED = 160, 320
# phases 17-18: the MLA family cut to MLA_LAYERS of 62 layers (the script's
# time limit, since phase 23) and the MoE family cut to MOE_LAYERS layers
# (memory: ~2.08e9 parameters a layer, f32 masters and their bf16 copy
# resident at once); the 2-layer f32 identity runs on the card and the CPU
# serve FAMILY_SMALL = (requests, shortest and longest prompt, new tokens)
MLA_ARCH, MOE_ARCH, MOE_LAYERS = "minicpm3-4b", "llama4-scout-17b-a16e", 4
MLA_LAYERS = 4
FAMILY_SMALL = (4, 32, 64, 8)
# the deep MLA tick's lean checks: a window of FAMILY_WINDOW ticks from
# FAMILY_START on (timed, traced; the sentinels' cost), past the last
# capture of the fused ticks' buckets (tick 32 of phase 4's workload; a
# traced MLA tick holds ~4k kernel records, each ~0.3 ms of the profiler's
# host time), FAMILY_FAULTS faults in each chaos run; the MoE tick's
# profiled window, MOE_WINDOW ticks
FAMILY_START, FAMILY_WINDOW, FAMILY_FAULTS, MOE_WINDOW = 40, 4, 3, 16
# phase 19: mixtral-8x22b at full width cut to MIXTRAL_LAYERS layers (bf16
# weights drawn leaf by leaf: ~5 GB a layer), its ring of MIXTRAL_WINDOW;
# MIXTRAL_REQUESTS prompts of MIXTRAL_PROMPT_MIN..MAX tokens, NEW new tokens
# each, over SLOTS slots at CHUNK; the static path's MIXTRAL_STATIC
# (prompts, tokens) past the window; the 2-layer f32 token gate's window
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_WINDOW = "mixtral-8x22b", 2, 4096
MIXTRAL_REQUESTS, MIXTRAL_PROMPT_MIN, MIXTRAL_PROMPT_MAX = 12, 3584, 6144
MIXTRAL_STATIC, SMALL_WINDOW = (2, 6144), 64
# phase 20: snapshots at ticks SNAP_TICKS (early, mid, late) of phase 4's
# workload at full width; the every-tick sweep at 2 layers f32 over
# SNAP_SMALL = (requests, shortest and longest prompt, new tokens)
SNAP_TICKS, SNAP_SMALL = (8, 48, 120), (4, 24, 56, 6)
# phase 20: whisper's snapshots with extras at these model ticks
SNAP_EXTRAS_TICKS = (2, 5, 9)
# phase 19 (c): the 2-layer f32 mixtral's workload, prompts past its window
MIXTRAL_SMALL = (4, 48, 120, 8)
# the new widths of the norm: MLA's kv and q latents, the two d_models
FAMILY_NORM_WIDTHS = (256, 768, 2560, 5120)
# phase 21: internlm2-1.8b with the exact softmax through the chunked stream
# at LONG_EXACT (batch, tokens); minicpm3-4b's MLA_LONG (batch, tokens)
# through the flash kernel at MLA_FLASH (B, H, S, qk head dim, v head dim);
# a training step at TRAIN_LONG (batch, tokens, microbatches, steps); the
# 2-layer f32 gates at LONG_SMALL tokens
LONG_EXACT = ((2, 4096), (1, 8192))
MLA_LONG, MLA_FLASH = (2, 4096), (1, 40, 4096, 96, 64)
TRAIN_LONG = (2, 4096, 2, 3)
LONG_SMALL = 4096
# phase 22: whisper-large-v3 and llama-3.2-vision-11b at full width cut to
# 2 + 2 and 5 layers (XATTN_DEPTH; the script's time limit), phase
# 4's workload (each request with seeded frames or patches);
# whisper's encoder shape in phase 2 (B, H, Hkv, S, S, D), non-causal; the
# 2-layer f32 gates' workload XATTN_SMALL (requests, shortest and longest
# prompt, new tokens), the VLM cut to one block over XATTN_SMALL_PATCHES
# patches (its CPU engine projects every slot's patches a tick)
XATTN_ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
WHISPER_ENCODER = (8, 20, 20, 1500, 1500, 64)
XATTN_SMALL, XATTN_SMALL_PATCHES, XATTN_GATE = (4, 24, 56, 6), 64, 0.5
XATTN_DEPTH = {"whisper-large-v3": {"n_layers": 2, "encoder_layers": 2},
               "llama-3.2-vision-11b": {"n_layers": 5}}
# phase 23: xlstm-350m and zamba2-7b at full width cut to SSM_DEPTH, phase 4's
# workload over the slab pool; zamba2's shared attention heads, and its
# forward's flash shape (B, H, Hkv, S, S, D) in phase 2; the 2-layer f32
# gates' cuts (zamba2 at full width in 2 groups
# at cadence 2, as reduce_config groups it), their snapshots at model ticks
# SNAP_EXTRAS_TICKS; training: TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MB
# microbatches, SSM_TRAIN_STEPS steps, zamba2 cut to SSM_TRAIN_GROUPS group
# (AdamW's f32 state of all 6.75e9 parameters does not fit on one card)
SSM_ARCHS = ("xlstm-350m", "zamba2-7b")
ZAMBA2_HEADS = 32
ZAMBA2_FLASH = (BATCH, ZAMBA2_HEADS, ZAMBA2_HEADS, PROMPT, PROMPT, 112)
SSM_TRAIN_STEPS, SSM_TRAIN_GROUPS = 3, 1
# the trained model's causality check: a token changed at CAUSAL_AT of
# CAUSAL_LEN (2 x 256: the chunked forms) may move no earlier logit past
# CAUSAL_ATOL (a leak moves them by O(1))
CAUSAL_LEN, CAUSAL_AT, CAUSAL_ATOL = 512, 300, 1e-3
SSM_SMALL = {"xlstm-350m": {}, "zamba2-7b": {"n_layers": 4, "attn_every": 2}}
# the served families' depth (of 24 and 81 layers; zamba2 in whole groups)
SSM_DEPTH = {"xlstm-350m": 3, "zamba2-7b": 9}
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
                "gn_softmax": ("gn_softmax_rows_kernel", "gn_softmax_wide_kernel"),
                "gn_attention": ("gn_attention_kernel", "gn_attention_tc_kernel")}


def record_counts(prof) -> dict:
    """Device records per kernel name in a torch.profiler trace."""
    return {e.key: e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA")}


def traced_rerun(label: str, rerun, want) -> tuple:
    """``rerun()`` -> (result, its CUDA-only trace, seconds), a profiled
    rerun that checks its own result, with the GN kernels' device records in
    its trace held against the launches the run executed (``want``, or
    ``want()`` read after each rerun when it is callable): an
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
    wanted = want
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        out, prof, seconds = rerun()
        want = wanted() if callable(wanted) else wanted
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
    contract, from the port's copy of its trace keys); over the slab pool
    one capture per step kind run, at most one each."""
    if m["transfer_guarded_ticks"] != m["model_ticks"]:
        fail(f"{label}: {m['model_ticks'] - m['transfer_guarded_ticks']} of "
             f"{m['model_ticks']} ticks were not graph replays")
    if not m["kv_paged"]:
        if (m["fused_step_compilations"] != (m["fused_ticks"] > 0)
                or m["decode_compilations"] != (m["model_ticks"] > m["fused_ticks"])
                or m["prefill_compilations"]):
            fail(f"{label}: slab captures fused {m['fused_step_compilations']}, decode "
                 f"{m['decode_compilations']}: one a step kind run")
        return
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


def timed_run(engine, reqs, marks: list | None = None) -> tuple[dict, float]:
    """A reset and a run of ``reqs``: (request id -> new tokens, seconds).
    With ``marks`` the run is stepped by hand and ``marks[i]`` gets the host
    clock at which model tick i began (the last entry: the run's end)."""
    engine.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if marks is None:
        toks = {c.request_id: c.new_tokens for c in engine.run(reqs)}
    else:
        for req in reqs:
            engine.submit(req)
        marks.append(t0)
        while engine.step():
            if engine.model_ticks == len(marks):
                marks.append(time.perf_counter())
        toks = {c.request_id: c.new_tokens for c in engine.completions}
    torch.cuda.synchronize()
    return toks, time.perf_counter() - t0


def eager_against_graphed(label: str, engine, reqs, graphed: dict, state: dict) -> dict:
    """The workload once more with the engine's tick function called
    directly (no graph): its tokens, held logits and real arena blocks (and
    int8 scales) must equal the graphed run's bit for bit; returns its
    tick and tok/s."""
    graphs, engine.shards[0]._graphs = engine.shards[0]._graphs, None
    try:
        toks, seconds = timed_run(engine, reqs)
    finally:
        engine.shards[0]._graphs = graphs
    if any(not np.array_equal(toks[i], graphed[i]) for i in graphed):
        fail(f"{label}: the eager tick's tokens differ from the graphed tick's")
    now = {"last_logits": engine.shards[0]._last_logits, **real_leaves(engine)}
    bad = [k for k, v in state.items() if not torch.equal(v, now[k])]
    if bad:
        fail(f"{label}: the eager tick's {bad} differ from the graphed tick's")
    return {"eager_seconds": seconds,
            "eager_tokens_per_s": engine.generated_tokens / seconds,
            "eager_mean_tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log]))}


def real_leaves(engine, d: int = 0) -> dict:
    """Shard ``d``'s device leaves a tick reads: the real blocks of its
    arenas (and scales; the write sink is never read), or its slabs."""
    nb = engine.pool.blocks_per_device if engine.paged else None
    return {k: v[:, :nb] for k, v in engine.pool.caches[d].items()}


def engine_state(engine) -> dict:
    """Clones of what a run leaves on the device: the held logits and the
    pool's real leaves."""
    return {"last_logits": engine.shards[0]._last_logits.clone(),
            **{k: v.clone() for k, v in real_leaves(engine).items()}}


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


def norm_case(rows: int, dtype, gen, cols: int = 2048, subtract_mean: bool = False,
              with_gamma: bool = True) -> dict:
    """The norm in RMS mode, or in LayerNorm mode with a beta, against its
    plain version; library: ``F.rms_norm`` or ``F.layer_norm`` (exact, not
    GN) with gamma and beta in x's dtype.  ``with_gamma=False``: no gamma
    (the mLSTM's normalizer)."""
    x = torch.randn(rows, cols, generator=gen, device=DEV).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(cols, generator=gen, device=DEV) if with_gamma else None
    beta = 0.1 * torch.randn(cols, generator=gen, device=DEV) if subtract_mean else None
    kw = {"subtract_mean": subtract_mean}
    check = compare(norm_ops.gn_layernorm(x, gamma, beta, **kw),
                    norm_ref.gn_layernorm_ref(x, gamma, beta, **kw), *norm_tol(dtype))
    check["ok"] = check["bad_rows"] == 0
    b_ms, b_by = roofline.work_bound(norm_ops.work(x, None, gamma, beta,
                                                   subtract_mean=subtract_mean))
    lib_w = None if gamma is None else gamma.to(dtype)
    lib_b = None if beta is None else beta.to(dtype)
    library = (functools.partial(F.layer_norm, x, (cols,), lib_w, lib_b) if subtract_mean
               else functools.partial(F.rms_norm, x, (cols,), lib_w))
    return {
        "name": "gn_rmsnorm", "mode": "layernorm" if subtract_mean else "rms",
        "layout": norm_ops.layout(x), "shape": [rows, cols], "dtype": str(dtype).split(".")[-1],
        "gamma": with_gamma, **check, "bound_ms": b_ms, "bound_by": b_by,
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
    b_ms, b_by = roofline.work_bound(norm_ops.work(x, r, gamma, None, subtract_mean=False))
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
    # phases 17-18: MLA's kv and q latents (256, 768) and minicpm3-4b's and
    # llama4-scout's d_model (2560, 5120) at a tick's rows
    norms += [norm_case(rows[0], torch.bfloat16, gen, cols=w) for w in FAMILY_NORM_WIDTHS]
    # phase 22: whisper's LayerNorm at its d_model (1280), the VLM's RMSNorm
    # at its (4096), a tick's rows
    norms += [norm_case(rows[0], torch.bfloat16, gen, cols=1280, subtract_mean=True),
              norm_case(rows[0], torch.bfloat16, gen, cols=4096)]
    # phase 23, a tick's rows: xlstm-350m's LayerNorm at its d_model (1024)
    # and its mixer's RMS normalizer without gamma (2048); zamba2-7b's RMS
    # at its d_model (3584) and its mixer's gated RMS norm (7168, gamma)
    norms += [norm_case(rows[0], torch.bfloat16, gen, cols=1024, subtract_mean=True),
              norm_case(rows[0], torch.bfloat16, gen, cols=2048, with_gamma=False),
              norm_case(rows[0], torch.bfloat16, gen, cols=3584),
              norm_case(rows[0], torch.bfloat16, gen, cols=7168)]
    return norms, fused


def attn_inputs(c: int, dtype, gen, v_ones: bool = False, exact: bool = False,
                max_bt: int = 66, h: int = 16):
    """N=8 sequences at serving widths (H16/Hkv8/D128, block 16; ``h`` 40 is
    llama4-scout's 40 q heads over 8 kv heads, a group of 5): lengths up to
    ``max_bt`` blocks (66: 1056 tokens, phase 4's; LONG_BT: 8224, the long
    phases'), shuffled tables with stale ids past each length, one empty row.
    ``exact``: q and k in {-1, 0, 1}, q nonzero on 8 head dims only, under a
    scale of 1/8: every score is exact in f32 whatever the summation order,
    lies on the Δ grid and within one logit unit, so no score can flip a Δ
    rounding and every online correction is a fine Q1.15 factor."""
    n, hkv, d, bs = SLOTS, 8, 128, BLOCK
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


def attn_case(c: int, dtype, gen, max_bt: int = 66, h: int = 16) -> dict:
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    args, lengths, n_valid = attn_inputs(c, dtype, gen, max_bt=max_bt, h=h)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    got = attn_ops.gn_paged_attention_chunk(*args)
    check = compare(got[lane], attn_ref.gn_paged_attention_chunk_ref(*args)[lane],
                    ATTN_ATOL_F32, rel)
    # scores exact, on the Δ grid and one logit wide: no flip is possible,
    # so every row must agree to the Q1.15 rounding of the corrections alone
    ex_args, _, _ = attn_inputs(c, dtype, gen, exact=True, max_bt=max_bt, h=h)
    exact = compare(attn_ops.gn_paged_attention_chunk(*ex_args, sm_scale=1 / 8)[lane],
                    attn_ref.gn_paged_attention_chunk_ref(*ex_args, sm_scale=1 / 8)[lane],
                    EXACT_ATOL, rel)
    # exact-ones: V = 1 turns each valid row into sum(p) = 1
    ones_args, _, _ = attn_inputs(c, torch.float32, gen, v_ones=True, max_bt=max_bt, h=h)
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
    b_ms, b_by = roofline.work_bound(attn_ops.work(*args))
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


def attn_int8_case(c: int, dtype, gen, max_bt: int = 66, h: int = 16) -> dict:
    """The int8 mode against its plain version: random arenas quantized on
    the card; exact scores (k in {-1, 0, 1} stored at scale 1, q likewise,
    sm_scale 1/8); V = 1 stored at scale 1; the empty sequence."""
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    (q, k_fp, v_fp, *ints), lengths, n_valid = attn_inputs(c, dtype, gen, max_bt=max_bt, h=h)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    (k8, ks), (v8, vs) = quantize(k_fp), quantize(v_fp)
    del k_fp, v_fp
    args, scales = (q, k8, v8, *ints), (ks, vs)
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    check = compare(got[lane], attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)[lane],
                    ATTN_ATOL_F32, rel)
    (eq, ek, ev, *eints), _, _ = attn_inputs(c, dtype, gen, exact=True, max_bt=max_bt, h=h)
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
    b_ms, b_by = roofline.work_bound(attn_ops.work(*args, scales=scales))
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



def alias_case(int8: bool, gen, c: int = CHUNK, dtype=torch.bfloat16) -> dict:
    """The prefix cache's tables at phase 2's widths (N 8, C 16, H16/Hkv8/D128,
    block 16, phase 15's 78 columns): lanes 0-5 read one 72-block prefix (the
    1152-token system + persona prompt), lane 0 four blocks of its own past
    it, lane 1 a forked copy (another id, the same contents; in int8 mode
    the int8 block and its scale) of lane 0's block 72, partially filled;
    lanes 6-7 own their chains; stale entries past every length.  Held
    against the plain version at phase 2's tolerances."""
    n, h, hkv, d, bs, max_bt = SLOTS, 16, 8, 128, BLOCK, 78
    rng = np.random.default_rng(15 + int8)
    nb = 6 * 6 + 72 + 2 * max_bt + 8
    perm = iter(rng.permutation(nb).tolist())
    prefix = [next(perm) for _ in range(72)]
    tables = rng.integers(0, nb, size=(n, max_bt))
    lengths = np.zeros(n, np.int64)
    for i in range(n):
        need = 76 if i == 0 else int(rng.integers(73, max_bt + 1))
        chain = list(prefix) if i < 6 else []
        chain += [next(perm) for _ in range(need - len(chain))]
        tables[i, :need] = chain
        lengths[i] = (need - 1) * bs + int(rng.integers(1, bs + 1))
    src, fork = int(tables[0, 72]), int(tables[1, 72])
    lengths[1] = 72 * bs + int(rng.integers(2, bs))  # inside the forked block
    tables[1, 73:] = rng.integers(0, nb, size=max_bt - 73)
    n_valid = np.minimum(rng.integers(1, c + 1, size=n), lengths)
    q = torch.randn(n, c, h, d, generator=gen, device=DEV).to(dtype)
    k = torch.randn(nb, bs, hkv, d, generator=gen, device=DEV).to(dtype)
    v = torch.randn(nb, bs, hkv, d, generator=gen, device=DEV).to(dtype)
    scales = None
    if int8:
        (k, ks), (v, vs) = quantize(k), quantize(v)
        scales = (ks, vs)
    for t in (k, v, *(scales or ())):
        t[fork] = t[src]
    ints = [torch.as_tensor(a, dtype=torch.int32).to(DEV)
            for a in (tables, lengths - n_valid, n_valid)]
    args = (q, k, v, *ints)
    lane = torch.as_tensor(np.arange(c)[None, :] < n_valid[:, None]).to(DEV)
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    want = attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)
    rel = 0.0 if dtype == torch.float32 else BF16_REL
    check = compare(got[lane], want[lane], ATTN_ATOL_F32, rel)
    check["ok"] = check["bad_rows"] <= FLIP_ROWS * check["rows"]
    return {"name": "gn_paged_attention_int8" if int8 else "gn_paged_attention",
            "case": "aliased", "design": attn_ops.call_design(*args[:3]),
            "shape": {"N": n, "C": c, "H": h, "Hkv": hkv, "D": d, "block": bs,
                      "max_len": int(lengths.max()), "shared_blocks": 72, "sharing_lanes": 6,
                      "forked": [src, fork], "kv": "int8" if int8 else "fp"},
            "dtype": str(dtype).split(".")[-1], **check}

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


# the softmax kernels' device names: the register layouts (an instance per
# element type, G threads a row, CPT chunks of 4 columns a thread) and the
# three-pass wide rows
SOFTMAX_LAYOUTS = {"gn_softmax_rows_kernel": "rows", "gn_softmax_wide_kernel": "wide"}
SOFTMAX_INSTANCE = re.compile(r"gn_softmax_rows_kernel<[^,>]+, (\d+), (\d+)>")


def softmax_layouts(fn) -> list[str]:
    """The softmax layouts a call of ``fn`` ran, read from the kernel names
    of its device trace: "rows G=g CPT=c" (g threads a row, c chunks a
    thread) or "wide" (the three-pass kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = set()
    for key in _device_us(prof):
        for name, layout in SOFTMAX_LAYOUTS.items():
            if name in key:
                inst = SOFTMAX_INSTANCE.search(key)
                out.add(f"{layout} G={inst[1]} CPT={inst[2]}" if inst else layout)
    return sorted(out)


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
        b_ms, b_by = roofline.work_bound(sm_ops.work(x))
        res.update(bound_ms=b_ms, bound_by=b_by,
                   layout=softmax_layouts(lambda: sm_ops.gn_softmax(x, cfg)), **timings(
                       lambda: sm_ops.gn_softmax(x, cfg), lambda: sm_ref.gn_softmax_ref(x, cfg),
                       lambda: torch.softmax(x, dim=-1), iters))
    return res


def fused_case(label: str, raw, mask, scale: float, gen_iters: int = 0) -> dict:
    """The fused entry on a call site's raw scores (one launch of scale,
    cast, mask, softmax and cast to the scores' dtype) against the chain it
    replaces over the softmax kernel (bit for bit: the gate) and against
    the plain chain (the softmax cases' tolerances, masked entries 0, Σp at
    f32); with ``gen_iters`` its time beside the chain's five launches and
    its bound: the raw scores read once, the probabilities written once in
    their dtype and the mask's own bytes (4 bytes an element at bf16)."""
    dtype = raw.dtype

    def chain():
        s = (raw * torch.tensor(scale, dtype=dtype)).float()
        if mask is not None:
            s = torch.where(mask, s, -1e30)
        return sm_ops.gn_softmax(s).to(dtype)

    def fused():
        return sm_ops.gn_softmax_scores(raw, scale, mask, dtype)

    got, want = fused(), chain()
    plain = sm_ref.gn_softmax_scores_ref(raw, scale, mask, dtype)
    f32 = dtype == torch.float32
    check = compare(got, plain, SM_ATOL_F32, 0.0 if f32 else BF16_REL)
    full = mask.expand(raw.shape) if mask is not None else None
    masked_max = (got[~full & full.any(-1, keepdim=True)].abs().max().item()
                  if full is not None and not full.all() else 0.0)
    sum_err = (got.double().sum(-1) - 1).abs().max().item() if f32 else None
    bitwise = bool(torch.equal(got, want))
    check["ok"] = (bitwise and check["bad_rows"] == 0 and masked_max == 0.0
                   and (sum_err is None or sum_err <= SUM_ATOL))
    res = {"name": "gn_softmax", "case": label, "entry": "gn_softmax_scores",
           "shape": list(raw.shape), "mask": None if mask is None else list(mask.shape),
           "dtype": str(dtype).split(".")[-1], "scale": scale,
           "layout": list(sm_ops.layout(raw.shape[-1])),
           "bitwise_chain": bitwise, **check, "sum_err": sum_err, "masked_max": masked_max}
    del got, want, plain
    if gen_iters:
        b_ms, b_by = roofline.work_bound(sm_ops.scores_work(raw, scale, mask, dtype))
        res.update(bound_ms=b_ms, bound_by=b_by, chain_ms=device_ms(chain, gen_iters),
                   **timings(fused, lambda: sm_ref.gn_softmax_scores_ref(raw, scale, mask, dtype),
                             None, gen_iters))
    return res


def fused_cases(gen) -> list[dict]:
    """The fused entry at each call site's shape, bf16 as served: ``_sdpa``'s
    static prefill (BATCH x 8 kv heads x 2 x PROMPT^2 under the causal
    (1, 1, 1, S, T) mask) and decode step (a (B, 1, 1, 1, T) mask: the slab
    decode's), the slab tick and the streamed paged read (SLOTS x 8 x 2 x
    CHUNK lanes over PROMPT + NEW columns, lane i at PROMPT - CHUNK + i, an
    (N, 1, 1, C, T) mask), whisper's cross-attention (20 heads over 1500
    frames, no mask), the VLM's (32 heads over 1601 patches, no mask: rows
    off the 16-byte grid), MLA's tick (40 heads, (N, 1, C, T)); and the
    slab tick at f32 (the Σp gate)."""
    def raw(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=DEV) * (3 / scale)).to(dtype)

    cols = PROMPT + NEW
    lanes = PROMPT - CHUNK + torch.arange(CHUNK, device=DEV)
    tick = (torch.arange(cols, device=DEV)[None, None, :] <= lanes[None, :, None]).expand(
        SLOTS, CHUNK, cols).contiguous()
    decode = (torch.arange(cols, device=DEV) <= PROMPT + NEW // 2)[None].expand(BATCH, cols)
    sc, mla_sc = 128 ** -0.5, 96 ** -0.5
    out = [fused_case("fused-prefill", raw(BATCH, 8, 2, PROMPT, PROMPT, scale=sc),
                      attention_mod.causal_mask(PROMPT, PROMPT, DEV)[:, :, None], sc, 10)]
    out.append(fused_case("fused-decode", raw(BATCH, 8, 2, 1, cols, scale=sc),
                          decode.contiguous()[:, None, None, None], sc, 50))
    for label in ("fused-slab-tick", "fused-paged-read"):
        out.append(fused_case(label, raw(SLOTS, 8, 2, CHUNK, cols, scale=sc),
                              tick[:, None, None], sc, 20))
    out.append(fused_case("fused-xattn-whisper", raw(SLOTS, 20, 1, CHUNK, 1500, scale=64 ** -0.5),
                          None, 64 ** -0.5, 20))
    out.append(fused_case("fused-xattn-vlm", raw(SLOTS, 32, 1, CHUNK, 1601, scale=sc),
                          None, sc, 20))
    out.append(fused_case("fused-mla-tick", raw(SLOTS, 40, CHUNK, cols, scale=mla_sc),
                          tick[:, None], mla_sc, 20))
    out.append(fused_case("fused-slab-tick-f32",
                          raw(SLOTS, 8, 2, CHUNK, cols, scale=sc, dtype=torch.float32),
                          tick[:, None, None], sc))
    out.append(site_trace(gen))
    return out


def device_kernels(fn) -> list[str]:
    """The device kernels one call of ``fn`` launches, in launch order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
            if str(e.device_type).endswith("CUDA")]


def site_trace(gen) -> dict:
    """The static prefill's one-pass attention (``attention._sdpa``: 2
    prompts of PROMPT tokens, internlm2's 16 q over 8 kv heads of 128, bf16,
    the causal mask) under the profiler: its device kernels in launch order,
    gated to one GN softmax launch with nothing before it but the kernels of
    the score product alone (traced apart): no scale, cast, ``where`` or
    copy kernel between the product and the softmax."""
    cfg = get_config(ARCH)
    b, s, dh = 2, PROMPT, cfg.head_dim
    q, k, v = (torch.randn(b, s, n, dh, generator=gen, device=DEV).bfloat16()
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    mask = attention_mod.causal_mask(s, s, DEV)
    qg = q.reshape(b, s, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, dh)

    def run():
        return attention_mod._sdpa(cfg, q, k, v, mask)

    run()
    torch.cuda.synchronize()
    product = set(device_kernels(lambda: attention_mod._score_product(qg, k)))
    before = sm_ops.launches
    kernels = device_kernels(run)
    sm = [i for i, name in enumerate(kernels) if "gn_softmax_rows_kernel" in name]
    between = [name[:60] for name in kernels[:sm[0]] if name not in product] if sm else None
    return {"name": "gn_softmax", "case": "site-trace", "shape": [b, s, cfg.n_heads, dh],
            "dtype": "bfloat16", "launches": sm_ops.launches - before,
            "kernels": [name[:60] for name in kernels], "between": between,
            "ok": len(sm) == 1 and between == [] and sm_ops.launches - before == 1}


def softmax_cases(gen) -> list[dict]:
    """The fused entry at every call site (``fused_cases``, the static
    prefill's first: the main path's call); then the kernel's own rows: the
    prefill's causally masked score rows (B·H·S, S) and a decode step's
    (B·H, max_seq) with the tail past pos masked, both f32 as the model
    cast its scores before the fused entry, and the long phases' decode
    rows (4128 and 8224 columns); a bf16 case, a ragged case, a vocab-wide
    row set (the wide-row path) and the reference's three LUT configs."""
    out = fused_cases(gen)
    torch.cuda.empty_cache()
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
    # phase 18's router rows (a static prefill's 8192 tokens over 16
    # experts) and phase 17's MLA score rows (a tick's N * 40 heads * C rows
    # over its 1056-column horizon, causally masked per lane)
    x, _ = softmax_rows(BATCH * PROMPT, 16, torch.float32, gen)
    out.append(softmax_case("router", x, None, iters=50))
    x, masked = softmax_rows(SLOTS * 40 * CHUNK, PROMPT + NEW, torch.float32, gen,
                             visible=lambda r: PROMPT - CHUNK + r % CHUNK)
    out.append(softmax_case("mla-tick", x, masked, iters=20))
    # phase 19's slab tick at mixtral's fused shape: SLOTS * 8 kv * 6 q heads
    # * CHUNK rows over the ring and the chunk's own keys (window + CHUNK)
    x, masked = softmax_rows(SLOTS * 48 * CHUNK, MIXTRAL_WINDOW + CHUNK, torch.float32, gen,
                             visible=lambda r: MIXTRAL_WINDOW + r % CHUNK)
    out.append(softmax_case("slab-tick", x, masked, iters=20))
    del x, masked
    # phase 22's cross-attention rows, a fused tick's (SLOTS * heads * CHUNK)
    # over the memory, every column visible: whisper's 1500 encoder frames
    # (20 heads), the VLM's 1601 patches (32 heads)
    for label, heads, cols in (("xattn-whisper", 20, 1500), ("xattn-vlm", 32, 1601)):
        x, _ = softmax_rows(SLOTS * heads * CHUNK, cols, torch.float32, gen)
        out.append(softmax_case(label, x, None, iters=20))
    del x
    # phase 23: zamba2-7b's shared attention on the slab tick (SLOTS * 32
    # heads * CHUNK rows over its slab of PROMPT + NEW slots, lane i of a
    # slot at position p seeing [0, p + i]) and in a static decode step
    # (BATCH * 32 rows over PROMPT + NEW columns, the tail past pos masked)
    x, masked = softmax_rows(SLOTS * ZAMBA2_HEADS * CHUNK, PROMPT + NEW, torch.float32, gen,
                             visible=lambda r: PROMPT - CHUNK + r % CHUNK)
    out.append(softmax_case("zamba2-slab-tick", x, masked, iters=20))
    x, masked = softmax_rows(BATCH * ZAMBA2_HEADS, PROMPT + NEW, torch.float32, gen,
                             visible=lambda r: torch.full_like(r, PROMPT + NEW // 2))
    out.append(softmax_case("zamba2-decode", x, masked, iters=50))
    del x, masked
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
        b_ms, b_by = roofline.work_bound(fa_ops.work(q, k, v, causal=causal))
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
    b_ms, b_by = roofline.work_bound(fa_ops.work(q, k, v, causal=True))
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


def fa_mla_case(gen, iters: int = 5) -> dict:
    """Phase 21's MLA prefill past 2048 tokens through the flash kernel
    (``mla._attend_chunked``): minicpm3-4b's (1, 40 heads, S 4096), q and k
    of head dim 96 (nope 64 + rope 32), v of 64 zero-padded to 96, causal,
    bf16, scale 96^-0.5.  The first 64 output columns against the plain
    version, the padded ones exactly 0; V = 1 over the real columns.  The
    bound counts the function's own work: q, k (96) and v, o (64) once, and
    the products at 96 (scores) and 64 (P·V) columns; SDPA takes v of 64."""
    b, h, s, dqk, dv = MLA_FLASH
    q, k, v = fa_inputs((b, h, h, s, s, dqk), torch.bfloat16, gen)
    v = F.pad(v[..., :dv], (0, dqk - dv)).contiguous()
    got = fa_ops.gn_attention(q, k, v, causal=True)
    check = compare(got[..., :dv], fa_ref.gn_attention_ref(q, k, v, causal=True)[..., :dv],
                    ATTN_ATOL_F32, BF16_REL)
    pad_zero = bool((got[..., dv:] == 0).all())
    ones = fa_ops.gn_attention(q, k, F.pad(torch.ones_like(v[..., :dv]), (0, dqk - dv)),
                               causal=True)
    ones_err = (ones[..., :dv].float() - 1.0).abs().max().item()
    del got, ones
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and pad_zero
                   and ones_err <= ONES_ATOL)
    seen = s * (s + 1) // 2
    item = q.element_size()
    b_ms, b_by = roofline.bound(2 * b * h * seen * (dqk + dv),
                                (2 * q.numel() + k.numel() + 2 * b * h * s * dv) * item,
                                torch.bfloat16)
    v64 = v[..., :dv].contiguous()
    try:
        F.scaled_dot_product_attention(q, k, v64, is_causal=True)
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v64, is_causal=True)
    except RuntimeError:  # no SDPA backend for two head dims
        lib = None
    return {"name": "gn_attention", "case": f"mla-{s}",
            "design": fa_ops.design(torch.bfloat16, TPU_SOFTMAX_LUT),
            "shape": {"B": b, "H": h, "Hkv": h, "Sq": s, "Sk": s, "D": dqk, "Dv": dv,
                      "causal": True},
            "dtype": "bfloat16", **check, "padded_columns_zero": pad_zero, "ones_err": ones_err,
            "bound_ms": b_ms, "bound_by": b_by,
            "ms": device_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True), iters),
            "call_ms": call_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True), iters),
            "plain_ms": device_ms(lambda: fa_ref.gn_attention_ref(q, k, v, causal=True), 3),
            "library_ms": None if lib is None else device_ms(lib, iters)}


def fa_window_case(label: str, shape, window: int, dtype, gen, iters: int = 0,
                   group: bool = False) -> dict:
    """The flash kernel with a sliding ``window`` (causal) against its plain
    version, with the exact-score and V = 1 checks, and at ``window`` past
    Sk bitwise the causal call.  ``group``: the kernel runs the whole shape
    and its first kv head's group of q heads is held against the plain
    version on that group alone (fa_long_case); exact scores on that group.
    With ``iters``: device times beside the banded bound and SDPA under the
    band as a boolean mask."""
    b, h, hkv, sq, sk, d = shape
    g = h // hkv
    rel = 0.0 if dtype == torch.float32 else BF16_REL

    def part(q, k, v):
        return [t[:, :n].contiguous() for t, n in ((q, g), (k, 1), (v, 1))] if group else [
            q, k, v]

    def run(q, k, v, **kw):
        out = fa_ops.gn_attention(q, k, v, causal=True, **kw)
        return out[:, :g] if group else out

    q, k, v = fa_inputs(shape, dtype, gen)
    check = compare(run(q, k, v, window=window),
                    fa_ref.gn_attention_ref(*part(q, k, v), causal=True, window=window),
                    ATTN_ATOL_F32, rel)
    eq, ek, ev = fa_inputs(shape, dtype, gen, exact=True)
    exact = compare(run(eq, ek, ev, window=window, sm_scale=1 / 8),
                    fa_ref.gn_attention_ref(*part(eq, ek, ev), causal=True, window=window,
                                            sm_scale=1 / 8), EXACT_ATOL, rel)
    del eq, ek, ev
    ones = fa_ops.gn_attention(q, k, torch.ones_like(v), causal=True, window=window)
    ones_err = (ones.float() - 1.0).abs().max().item()
    del ones
    wide = torch.equal(fa_ops.gn_attention(q, k, v, causal=True, window=sk + 1),
                       fa_ops.gn_attention(q, k, v, causal=True))
    check["ok"] = (check["bad_rows"] <= FLIP_ROWS * check["rows"] and exact["bad_rows"] == 0
                   and ones_err <= ONES_ATOL and wide)
    res = {"name": "gn_attention", "case": label, "design": fa_ops.design(dtype, TPU_SOFTMAX_LUT),
           "shape": {"B": b, "H": h, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d, "causal": True,
                     "window": window},
           "dtype": str(dtype).split(".")[-1], **check,
           "exact_scores": {key: exact[key] for key in ("max_abs_err", "bad_rows")},
           "ones_err": ones_err, "wide_window_bitwise_causal": wide}
    if iters:
        b_ms, b_by = roofline.work_bound(fa_ops.work(q, k, v, causal=True, window=window))
        band = attention_mod.causal_mask(sq, sk, DEV, window)[0, 0]
        lib = functools.partial(F.scaled_dot_product_attention, q, k, v, attn_mask=band,
                                enable_gqa=True)
        res.update(bound_ms=b_ms, bound_by=b_by,
                   ms=device_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True, window=window),
                                iters),
                   call_ms=call_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True,
                                                               window=window), iters),
                   causal_ms=device_ms(lambda: fa_ops.gn_attention(q, k, v, causal=True), iters),
                   plain_ms=None if group else device_ms(
                       lambda: fa_ref.gn_attention_ref(q, k, v, causal=True, window=window), 3),
                   plain_group_ms=device_ms(lambda: fa_ref.gn_attention_ref(
                       *part(q, k, v), causal=True, window=window), 3) if group else None,
                   library_ms=device_ms(lib, iters))
    return res


def attention_cases(gen) -> list[dict]:
    """The forward's shape (B 8, H 16, Hkv 8, S = prompt + new, D 128,
    causal) in bf16 and f32, a non-causal case, a KV-prefix case (Sk > Sq,
    the causal offset), a ragged S, the long prefills' shapes, and phases
    21-22's: whisper's encoder (non-causal, ragged 1500 frames) and MLA's
    padded head dim past 2048 tokens; phase 23's: zamba2-7b's shared
    attention in its forward (head dim 112, inside the kernel's 128
    instantiation: the ragged D edge masked)."""
    fwd = (BATCH, 16, 8, PROMPT + NEW, PROMPT + NEW, 128)
    return [fa_case("forward", fwd, torch.bfloat16, True, gen, iters=10),
            fa_case("forward", fwd, torch.float32, True, gen, iters=5),
            fa_case("non-causal", (2, 16, 8, 256, 256, 128), torch.bfloat16, False, gen),
            fa_case("kv-prefix", (1, 8, 1, 64, 256, 32), torch.float32, True, gen),
            fa_case("ragged", (2, 16, 8, 333, 333, 128), torch.float32, True, gen)] + [
                fa_long_case(b, s, gen) for b, s in LONG_BATCHES] + window_cases(gen) + [
                fa_case("whisper-encoder", WHISPER_ENCODER, torch.bfloat16, False, gen, iters=5),
                fa_mla_case(gen),
                fa_case("zamba2-forward", ZAMBA2_FLASH, torch.bfloat16, True, gen, iters=5)]


def window_cases(gen) -> list[dict]:
    """Phase 19's windowed prefill: mixtral's shape (1, 48 q, 8 kv, S 8192,
    D 128), window 4096, bf16 on the tensor cores (a group of 6 held against
    the plain version); a ragged bf16 case with band-edge tiles in a KV
    prefix, and an f32 case on the CUDA cores."""
    return [fa_window_case("window-prefill-8192", (1, 48, 8, 8192, 8192, 128), MIXTRAL_WINDOW,
                           torch.bfloat16, gen, iters=5, group=True),
            fa_window_case("window-ragged", (2, 16, 8, 333, 397, 128), 100, torch.bfloat16, gen),
            fa_window_case("window-f32", (2, 8, 2, 300, 300, 64), 64, torch.float32, gen,
                           iters=5)]


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
    # the prefix cache's aliased tables (phase 15), after the main cases
    attns.append(alias_case(False, gen))
    attns_int8.append(alias_case(True, gen))
    # phase 18: llama4-scout's group of 5 (40 q heads over 8 kv heads): 80 q
    # rows a kv head at C = 16, past the tensor cores' 64 (the CUDA-core
    # design), 5 at C = 1 (the tensor cores), fp and int8
    attns += [attn_case(c, torch.bfloat16, gen, h=40) for c in (CHUNK, 1)]
    attns_int8 += [attn_int8_case(c, torch.bfloat16, gen, h=40) for c in (CHUNK, 1)]
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
        with swapped("gn_softmax_scores", sm_ref.gn_softmax_scores_ref):
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


def timed_replay(label: str, engine, reqs, first: dict, want: dict,
                 marks: list | None = None) -> tuple:
    """After a continuous path's first run (which captured its graphs): the
    capture contract, then a timed rerun (``timed_run``, ``marks``), every
    tick a replay, its launch counters gated as ``want`` (the first run's),
    its tokens as ``first``, and no capture more.  Returns (the captures per
    kind, the rerun's seconds, its ``metrics()``)."""
    m = engine.metrics()
    check_graphs(label, m)
    captures = (m["fused_step_compilations"], m["decode_compilations"])
    counters.reset()
    again, steady_s = timed_run(engine, reqs, marks)
    if counters.launch_counts() != want:
        fail(f"{label}: replayed launches {counters.launch_counts()} != {want}")
    if any(not np.array_equal(first[i], again[i]) for i in first):
        fail(f"{label}: reset + rerun gave different tokens")
    m = engine.metrics()
    check_graphs(label, m)
    if (m["fused_step_compilations"], m["decode_compilations"]) != captures:
        fail(f"{label}: the rerun captured again: {captures} -> {m}")
    return captures, steady_s, m


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
    captures, steady_s, m = timed_replay(label, engine, reqs, first, want)
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
            "fused_buckets": m.get("fused_buckets"), "decode_buckets": m.get("decode_buckets"),
            "capture_seconds": m["capture_seconds"], "steady_seconds": steady_s,
            "steady_tokens_per_s": m["generated_tokens"] / steady_s,
            "steady_mean_tick_ms": float(np.mean(steady_tick_ms)),
            "profiled_ticks": traced, "profiled_rerun_seconds": rerun_s, "traces": traces,
            "device_busy_seconds": busy_s, "device_busy_share": busy_s / base_s,
            "kernel_records": records, **eager}


def continuous_want(layers: int, ticks: int, int8: bool, read_path: str = "kernel",
                    sentinels: bool = True, mla: bool = False, moe: bool = False,
                    cross: int = 0) -> dict:
    """The launches of ``ticks`` paged ticks: a paged read a layer (fp or
    int8 mode; with the streamed or gathered read a softmax instead), 2L + 1
    norms (with the sentinels one more: the head's σ probe) and 2L - 1 of
    them fused, a tick.  MLA reads through the streamed read and norms its
    two latents (2L more norms); MoE adds a router softmax a layer; each of
    ``cross`` cross-attention blocks a pass (``cross_blocks``) a fused norm
    and a softmax.  The slab tick (``read_path`` "slab") reads its score
    rows through a softmax a layer, as the streamed read."""
    read = layers * ticks
    kernel = read_path == "kernel"
    return {"gn_rmsnorm": (2 * layers + 1 + sentinels + 2 * layers * mla + cross) * ticks,
            "gn_rmsnorm_fused": (2 * layers - 1 + cross) * ticks,
            "gn_paged_attention": read if kernel and not int8 else 0,
            "gn_paged_attention_int8": read if kernel and int8 else 0,
            "gn_softmax": (0 if kernel else read) + read * moe + cross * ticks,
            "gn_attention": 0}


def cross_blocks(cfg) -> int:
    """Cross-attention blocks a decoder pass runs, each a norm that follows
    a residual add (fused) and a GN softmax over its memory: encdec's ln_x
    + xattn a layer, the VLM's gated block before every cross_attn_every
    layers (its first norm is plain, but then layer 0's ln1 is fused)."""
    if cfg.family == "encdec":
        return cfg.n_layers
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    return 0


def encoder_want(cfg, passes: int) -> dict:
    """The launches of ``passes`` runs of whisper's encoder (an admission's,
    or a static prefill's or forward's over its batch): 2E + 1 norms (2E
    fused: every ln1 but the first, every ln2, the final norm) and a
    non-causal flash attention a layer."""
    e = cfg.encoder_layers if cfg.family == "encdec" else 0
    return {"gn_rmsnorm": (2 * e + 1) * passes * (e > 0), "gn_rmsnorm_fused": 2 * e * passes,
            "gn_paged_attention": 0, "gn_paged_attention_int8": 0, "gn_softmax": 0,
            "gn_attention": e * passes}


def admissions(engine) -> int:
    """Admissions and resumes in ``engine``'s event log: each runs the
    encoder once (encdec)."""
    return sum(e[0] in ("admit", "resume") for e in engine.event_log)


def add_launches(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def want_for(engine, ticks: int, passes=(), admitted: int | None = None) -> dict:
    """``continuous_want`` for ``engine``'s model, pool, read and sentinels,
    plus the static passes of its int8 -> fp fallbacks (``passes``, from
    ``fallback_passes``; ``static_want``, each a prefill that encodes), plus
    the encoder of each of ``admitted`` admissions (default: every one in
    the event log).  An SSM or hybrid model's slab ticks: ``recurrent_want``."""
    cfg = engine.model.cfg
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_want(cfg, ticks)
    # a sharded engine's tick is each shard's tick, each launching alike
    want = continuous_want(cfg.n_layers, ticks * engine.num_devices, engine.kv_dtype == "int8",
                           engine.read_path, engine.sentinels, mla=cfg.mla is not None,
                           moe=cfg.moe is not None, cross=cross_blocks(cfg))
    for n in passes:
        want = add_launches(want, static_want(cfg, n), encoder_want(cfg, int(n > 0)))
    return add_launches(want, encoder_want(cfg, admissions(engine) if admitted is None
                                           else admitted))


class fallback_passes:
    """Within the block, the static passes of each of ``engine``'s int8 ->
    fp fallbacks (its ``generate``: a prefill and a decode step a remaining
    token; none when nothing remains), listed as they happen."""

    def __init__(self, engine):
        self.engine, self.passes = engine, []

    def __enter__(self) -> list:
        engine, self.saved = self.engine, self.engine._int8_fallback

        def counted(slot):
            st = engine._slots[slot]
            remaining = st.req.max_new_tokens - len(st.generated)
            self.passes.append(remaining + 1 if remaining > 0 else 0)
            self.saved(slot)

        engine._int8_fallback = counted
        return self.passes

    def __exit__(self, *exc):
        self.engine._int8_fallback = self.saved


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
    if not bool(torch.isfinite(engine.shards[0]._last_logits).all()):
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
    return {**res, "new_tokens": first, "_engine": (engine, reqs)}


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
def first_run(label: str, engine, reqs,
              fallbacks_ok: bool = False) -> tuple[dict, dict, float]:
    """A continuous path's first run, its graphs captured on the way, the
    launch counters set to 0 just before it and read just after: the exact
    launches of its ticks (for the engine's KV dtype and paged read), no
    plain version on a CUDA tensor, every request done with its budget,
    every block back, finite held logits.  A request the int8 clip
    watchdog moves to the fp static path fails the run unless
    ``fallbacks_ok``; then that ``generate``'s launches are counted in
    (``static_want``: a prefill and a decode step a remaining token).
    Returns (request id -> new tokens, the launches, seconds)."""
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    with fallback_passes(engine) as passes:
        comps = engine.run(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    if passes and not fallbacks_ok:
        fail(f"{label}: {len(passes)} requests fell back from int8 to the fp static path")
    want = want_for(engine, engine.metrics()["model_ticks"], passes)
    if launches != want:
        fail(f"{label}: serving launches {launches} != {want}")
    if any(plain.values()):
        fail(f"{label}: plain-version calls on CUDA tensors in the serving run: {plain}")
    if len(comps) != len(reqs) or any(len(c.new_tokens) != r.max_new_tokens for c, r in
                                       zip(sorted(comps, key=lambda c: c.request_id), reqs)):
        fail(f"{label}: not every request completed with its budget")
    if getattr(engine.pool, "blocks_in_use", 0) or engine.pool.num_free != engine.num_slots:
        fail(f"{label}: slots or blocks not returned")
    if not bool(torch.isfinite(engine.held_logits()).all()):
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
    replays = continuous_replays("int8", engine, reqs, first, launches, window=LONG_WINDOW)
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
    return {**res, "new_tokens": first, "_engine": (engine, reqs)}


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
              gated: bool = True, faults: int = CHAOS_FAULTS,
              fallbacks_ok: bool = False) -> dict:
    """A reset run of ``reqs`` with a fault injected every CHAOS_EVERY model
    ticks (``faults`` in all, ``kinds`` in turn), the ledger checked after
    every tick.  Gated: every fault flagged within one tick of its
    injection, every poisoned block quarantined, launches exact, every tick
    a replay, nothing plain on the card, the run drained (with no int8 ->
    fp fallback unless ``fallbacks_ok``: their static launches are then
    counted in).  Reported: each fault's detection latency (None: missed),
    and the requests whose tokens equal the fault-free run's ``clean``."""
    engine.reset()
    inj = FaultInjector(engine, seed=SEED, leaves=leaves)
    for req in reqs:
        engine.submit(req)
    torch.cuda.synchronize()
    counters.reset()
    records = []
    t0 = time.perf_counter()
    with fallback_passes(engine) as passes:
        while engine.step():
            engine.pool.check_ledger()
            if (len(records) < faults
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
    want = want_for(engine, m["model_ticks"], passes)
    missed = [f for f, lat in zip(res["faults"], latency) if lat is None or lat > 1]
    unquarantined = [r.block for r in records
                     if r.kind != "table" and r.block not in engine.pool.quarantined]
    if len(records) < faults or missed or unquarantined:
        fail(f"{label}: {len(records)} faults, not flagged within a tick: {missed}, poisoned "
             f"blocks not quarantined: {unquarantined}")
    if counters.launch_counts() != want or any(counters.plain_cuda_calls().values()):
        fail(f"{label}: launches {counters.launch_counts()} != {want}, plain "
             f"{counters.plain_cuda_calls()}")
    if m["transfer_guarded_ticks"] != m["model_ticks"]:
        fail(f"{label}: {m['model_ticks'] - m['transfer_guarded_ticks']} ticks not replayed")
    if (len(reasons) != len(reqs) or engine.pool.blocks_in_use
            or (m["fallbacks"] and not fallbacks_ok)):
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


def step_opt() -> OptimizerConfig:
    """Phase 11's optimizer (phase 26 trains with it too)."""
    return OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 2)


def phase_train() -> dict:
    """Full-width, full-depth training: bf16 compute over f32 masters,
    TRAIN_STEPS AdamW steps of TRAIN_MB microbatches on one repeated batch.
    Gated: the launches exact, no plain version on the card, every loss and
    grad_norm finite, the loss falling every step.  Reported: ms a step (the
    first apart), tokens/s, peak memory, the device-busy share of a
    profiled step, and one microbatch's launches in forward and backward."""
    cfg = get_config(ARCH)
    model = make_model(cfg)
    opt = step_opt()
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
def run_launcher(argv: list) -> dict:
    """``python -m <argv>`` from the repo root as a user runs it: its exit
    code, seconds, output and last line."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_FAIL_AT_STEP", None)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", *argv], env=env, cwd=ROOT, timeout=300,
                         capture_output=True, text=True)
    return {"rc": run.returncode, "seconds": time.perf_counter() - t0, "stdout": run.stdout,
            "stderr": run.stderr, "last_line": (run.stdout.strip().splitlines() or [""])[-1]}


def _chain(steps: list) -> dict:
    return {name: run_launcher(argv) for name, argv in steps}


# the launcher subprocesses of phases 12, 21 and 23, as chains that run in
# order within themselves (a serve reads its train's checkpoint, a resume its
# cut run's) and side by side across themselves: name -> its steps under a
# run directory
_TRAIN = ["repro_torch.launch.train", "--smoke", "--steps", "3"]
LAUNCH_CHAINS = {
    "ckpt": lambda d: [("train", _TRAIN + ["--outdir", str(d / "smoke")]),
                       ("serve", ["repro_torch.launch.serve", "--smoke", "--ckpt",
                                  str(d / "smoke" / "ckpt"), "--batches", "1"])],
    "ckpt-resume": lambda d: [
        ("train_fail_at_2", _TRAIN + ["--checkpoint-every", "1", "--outdir", str(d / "cut"),
                                      "--fail-at", "2"]),
        ("train_resume", _TRAIN + ["--checkpoint-every", "1", "--outdir", str(d / "cut")])],
    "train-long": lambda d: [("train-long", [
        "repro_torch.launch.train", "--smoke", "--seq", str(TRAIN_LONG[1]), "--batch", "1",
        "--steps", "2", "--outdir", str(d / "train-long")])],
    "ssm-train": lambda d: [("ssm-train", [
        "repro_torch.launch.train", "--arch", "xlstm-350m", "--smoke", "--steps", "3",
        "--outdir", str(d / "ssm-train")])],
}
_LAUNCHED: dict = {}
_POOL = concurrent.futures.ThreadPoolExecutor(max_workers=len(LAUNCH_CHAINS))


def launched(name: str, root: Path | None = None) -> None:
    """Start the launcher chain ``name`` under ``root`` (a temporary
    directory of its own by default, removed when ``launch_result`` reads
    the chain), unless it already runs."""
    if name not in _LAUNCHED:
        own = root is None
        root = root or Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
        _LAUNCHED[name] = (_POOL.submit(_chain, LAUNCH_CHAINS[name](root)), root if own else None)


def launch_result(name: str) -> dict:
    """The runs of the launcher chain ``name`` by launcher name, started now
    if it was not (waits for it to end)."""
    launched(name)
    future, own_root = _LAUNCHED[name]
    try:
        return future.result()
    finally:
        if own_root is not None:
            shutil.rmtree(own_root, ignore_errors=True)


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
        # every launcher chain of the script at once (phases 21 and 23 read
        # theirs later); this phase waits for its own two
        t0 = time.perf_counter()
        for name in LAUNCH_CHAINS:
            launched(name, tmp if name.startswith("ckpt") else None)
        runs = {**launch_result("ckpt"), **launch_result("ckpt-resume")}
        launchers = {name: {k: run[k] for k in ("rc", "seconds", "last_line")}
                     for name, run in runs.items()}
        launchers["wall_seconds"] = time.perf_counter() - t0
        for name, want_rc in (("train", 0), ("serve", 0), ("train_fail_at_2", 42),
                              ("train_resume", 0)):
            run = runs[name]
            if run["rc"] != want_rc:
                fail(f"ckpt: launch {name} exited {run['rc']}:\n{run['stdout'][-2000:]}\n"
                     f"{run['stderr'][-2000:]}")
            if name == "serve" and "restored checkpoint step 3" not in run["stdout"]:
                fail(f"ckpt: launch.serve did not restore the checkpoint:\n"
                     f"{run['stdout'][-2000:]}")
            if name == "train_resume" and "[resume] from checkpoint step 2" not in run["stdout"]:
                fail(f"ckpt: the rerun did not resume from step 2:\n{run['stdout'][-2000:]}")
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


# ----------------------------------------------------------- phases 15, 16 --
def served_run(label: str, engine, reqs) -> dict:
    """``reqs`` through a reset engine, one ``step`` at a time with the host
    clock (``time.time``, as the completions' stamps) read at each step's
    start; the launch counters set to 0 just before and read just after:
    the launches exact for the ticks run, no plain version on the card, the
    ledger balanced, only cached blocks left resident, finite held logits,
    the sentinels silent."""
    engine.reset()
    for req in reqs:
        engine.submit(req)
    starts = {}
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    while True:
        starts.setdefault(engine.step_count, time.time())
        if not engine.step():
            break
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    m = engine.metrics()
    want = want_for(engine, m["model_ticks"])
    if launches != want:
        fail(f"{label}: serving launches {launches} != {want}")
    if any(plain.values()):
        fail(f"{label}: plain-version calls on CUDA tensors in the serving run: {plain}")
    engine.pool.check_ledger()
    if (engine.pool.blocks_in_use != engine.pool.cached_blocks
            or engine.pool.num_free != engine.num_slots):
        fail(f"{label}: {engine.pool.blocks_in_use} blocks in use, "
             f"{engine.pool.cached_blocks} cached, {engine.pool.num_free} slots free")
    if not bool(torch.isfinite(engine.shards[0]._last_logits).all()):
        fail(f"{label}: non-finite logits")
    check_silent(label, engine)
    comps = list(engine.completions)
    return {"tokens": {c.request_id: c.new_tokens for c in comps}, "completions": comps,
            "launches": launches, "seconds": seconds, "starts": starts,
            "tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log])),
            "tokens_per_s": m["generated_tokens"] / seconds, "model_ticks": m["model_ticks"]}


def ttft(run: dict, klass=None) -> dict:
    """TTFT over the served requests (of ``klass``): on the step clock
    (arrival -> first token) and in ms (the host clock at the first step at
    or after the arrival -> the first token's stamp); p50, p99 and mean."""
    steps, ms = [], []
    for c in run["completions"]:
        if c.finish_reason == "rejected" or (klass and c.req_class != klass):
            continue
        steps.append(c.ttft_steps)
        start = min(s for s in run["starts"] if s >= c.arrival_step)
        ms.append((c.first_token_time - run["starts"][start]) * 1e3)
    if not steps:
        return {"n": 0}
    return {"n": len(steps), **{f"{name}_{q}": float(np.percentile(vals, p))
                                for name, vals in (("steps", steps), ("ms", ms))
                                for q, p in (("p50", 50), ("p99", 99))},
            "steps_mean": float(np.mean(steps)), "ms_mean": float(np.mean(ms))}


def checked_forks(pool) -> list:
    """Wrap the pool's fork: after each, its destination block read back
    equals its source in every leaf (the arenas and, over int8, the
    scales).  Returns the list of verdicts, one per fork."""
    verdicts, fork = [], pool.fork_block

    def checked(src: int, dst: int) -> None:
        fork(src, dst)
        verdicts.append(all(torch.equal(leaf[:, dst], leaf[:, src])
                            for leaf in pool.caches[0].values()))

    pool.fork_block = checked
    return verdicts


def checked_spills(engine) -> dict:
    """Wrap the spill path: each payload equals its chain's blocks at the
    eviction, each restore leaves the new chain equal to the payload, and the
    resumed slot's held-logits row equals the spilled one (read back after
    the admission pass), in every leaf.  Returns the running counts."""
    pool, st = engine.pool, {"spills": 0, "restores": 0, "bytes": 0, "bad": []}
    extract, restore, admit = pool.extract_blocks, pool.restore_blocks, engine._admit

    def chain_blocks(slot, n):
        ix = torch.tensor(pool.chain_of(slot)[:n], dtype=torch.long, device=DEV)
        return {k: leaf.index_select(1, ix).cpu() for k, leaf in pool.caches[0].items()}

    def checked_extract(slot):
        payload = extract(slot)
        n = payload["len"]
        now = chain_blocks(slot, n)
        if any(not torch.equal(now[k], t[:, :n]) for k, t in payload["layers"].items()):
            st["bad"].append(("spill", engine.step_count, slot))
        st["spills"] += 1
        st["bytes"] += sum(t.numel() * t.element_size() for t in payload["layers"].values())
        return payload

    def checked_restore(slot, payload):
        restore(slot, payload)
        n = payload["len"]
        now = chain_blocks(slot, n)
        if any(not torch.equal(now[k], t[:, :n]) for k, t in payload["layers"].items()):
            st["bad"].append(("restore", engine.step_count, slot))
        st["restores"] += 1

    def checked_admit():
        spilled = {rid: sus.spill["last_logits"] for rid, sus in engine._suspended.items()
                   if sus.spill is not None}
        first = len(engine.event_log)
        admit()
        for e in engine.event_log[first:]:
            if e[0] == "resume" and e[2] in spilled:
                if not torch.equal(engine.shards[0]._last_logits[e[3]].cpu(), spilled[e[2]]):
                    st["bad"].append(("logits", engine.step_count, e[3]))

    pool.extract_blocks, pool.restore_blocks, engine._admit = (checked_extract, checked_restore,
                                                               checked_admit)
    return st


def small_model():
    """Phase 3's cut: the full widths at 2 layers, float32."""
    model = make_model(dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32"))
    return model, model.init(SEED, DEV)


def phase_prefix() -> dict:
    """Chat behind one system prompt at full width (module docstring, phase
    15): the prefix cache off and on over the fp pool, on over the int8
    pool, and on over a tight arena; then the 2-layer f32 cut's tokens with
    the cache on equal to those with it off, fp and int8."""
    model = make_model(get_config(ARCH))
    master = model.init(SEED, DEV)
    reqs = shared_prefix_requests(model.cfg, **PREFIX)
    max_seq = required_max_seq(reqs)
    footprint = -(-max_seq // BLOCK)
    runs = (("prefix-off", {}), ("prefix-on", {"prefix_cache": True}),
            ("prefix-int8", {"prefix_cache": True, "kv_dtype": "int8"}),
            ("prefix-tight", {"prefix_cache": True, "num_blocks": PREFIX_TIGHT * footprint}))
    res, total, off = {}, dict.fromkeys(counters.WRAPPERS, 0), None
    for label, kw in runs:
        engine = ContinuousEngine(model, master, num_slots=SLOTS, max_seq=max_seq, chunk=CHUNK,
                                  block_size=BLOCK, device=DEV, **kw)
        forks = checked_forks(engine.pool)
        first = served_run(label, engine, reqs)
        m = engine.metrics()
        check_graphs(label, m)
        if len(first["completions"]) != len(reqs) or any(
                len(t) != PREFIX["max_new_tokens"] for t in first["tokens"].values()):
            fail(f"{label}: not every request completed with its budget")
        if not all(forks) or len(forks) != m.get("prefix_forks", 0):
            fail(f"{label}: {forks.count(False)} of {len(forks)} forks not bitwise "
                 f"({m.get('prefix_forks', 0)} counted)")
        total = {k: total[k] + first["launches"][k] for k in total}
        captures = (m["fused_step_compilations"], m["decode_compilations"])
        if label == "prefix-on":  # the timed, profiled and eager reruns
            replays = continuous_replays(label, engine, reqs, first["tokens"],
                                         first["launches"], window=LONG_WINDOW)
        else:
            replays = {}
        steady = served_run(label, engine, reqs)
        if any(not np.array_equal(t, steady["tokens"][i]) for i, t in first["tokens"].items()):
            fail(f"{label}: reset + rerun gave different tokens")
        m = engine.metrics()
        if (m["fused_step_compilations"], m["decode_compilations"]) != captures:
            fail(f"{label}: the rerun captured again")
        if label == "prefix-tight" and not m["prefix_evictions"]:
            fail(f"{label}: no eviction in an arena of {engine.pool.num_blocks} blocks")
        if label == "prefix-off":
            off = first["tokens"]
        prefix = common_prefix(first["tokens"], off)
        res[label] = {
            "num_blocks": engine.pool.num_blocks, "model_ticks": first["model_ticks"],
            "fused_ticks": m["fused_ticks"], "first_tokens_per_s": first["tokens_per_s"],
            "first_mean_tick_ms": first["tick_ms"], "steady_tokens_per_s": steady["tokens_per_s"],
            "steady_mean_tick_ms": steady["tick_ms"], "ttft": ttft(steady),
            "captures": {"fused": captures[0], "decode": captures[1]},
            **{k: m[k] for k in ("prefix_hit_rate", "prefix_hit_requests", "prefix_forks",
                                 "prefix_evictions", "prefix_cached_blocks", "prefix_inserts",
                                 "peak_blocks_in_use") if k in m},
            "launches": first["launches"],
            **{k: replays[k] for k in ("device_busy_share", "eager_mean_tick_ms",
                                       "profiled_ticks") if k in replays},
            # full width bf16, random weights: reported, not gated
            "off_common_prefix_mean": float(np.mean(prefix)),
            "off_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}"}
        print(f"[{label}] {json.dumps(res[label])}")
        del engine
        torch.cuda.empty_cache()
    # the 2-layer f32 cut: the cache changes no greedy token
    small, small_master = small_model()
    identity = {}
    for kv in ("fp", "int8"):
        toks = {}
        for on in (False, True):
            engine = ContinuousEngine(small, small_master, num_slots=SLOTS, max_seq=max_seq,
                                      chunk=CHUNK, block_size=BLOCK, kv_dtype=kv,
                                      prefix_cache=on, device=DEV)
            toks[on] = {c.request_id: c.new_tokens for c in engine.run(reqs)}
            hits = engine.metrics().get("prefix_hit_requests", 0)
            del engine
        same = sum(np.array_equal(t, toks[True][i]) for i, t in toks[False].items())
        identity[kv] = f"{same}/{len(toks[False])}"
        if same != len(reqs) or not hits:
            fail(f"prefix-2l-{kv}: {same} of {len(reqs)} requests kept their greedy tokens with "
                 f"the cache on ({hits} hits)")
    torch.cuda.empty_cache()
    print(f"[prefix] {json.dumps({'small_f32_identical': identity})}")
    return {"runs": res, "launches": total, "small_f32_identical": identity}


def set_policy(engine, sched: str, preempt: str, shed: int = 0) -> None:
    """Give ``engine`` another SLA policy: its ``reset`` (at the next run)
    builds the scheduler from these, and its graphs, which no policy
    enters, are kept, so a run after the first captures nothing new."""
    engine.sched_policy, engine.preempt_mode, engine.shed_backlog = sched, preempt, shed


def phase_sla() -> dict:
    """Interactive and batch traffic on one card at full width (module
    docstring, phase 16): FCFS, priority with recompute and with spill
    preemption, and priority + spill with a shedding watermark on one engine
    over the fp pool (the policy set between runs), spill over the int8
    pool; then the 2-layer f32 cut's preempted requests' tokens equal to the
    preempt-off priority run's."""
    model = make_model(get_config(ARCH))
    master = model.init(SEED, DEV)
    reqs = sla_requests(model.cfg, **SLA)
    by_id = {r.id: r for r in reqs}
    max_seq = required_max_seq(reqs)
    runs = (("sla-fcfs", "fp", ("fcfs", "off")), ("sla-recompute", "fp", ("priority", "recompute")),
            ("sla-spill", "fp", ("priority", "spill")),
            ("sla-shed", "fp", ("priority", "spill", SLA_SHED)),
            ("sla-spill-int8", "int8", ("priority", "spill")))
    res, total, engine = {}, dict.fromkeys(counters.WRAPPERS, 0), None
    for label, kv, policy in runs:
        fresh = engine is None or engine.pool.kv_dtype != kv
        if fresh:
            del engine
            torch.cuda.empty_cache()
            engine = ContinuousEngine(model, master, num_slots=SLOTS, max_seq=max_seq,
                                      chunk=CHUNK, block_size=BLOCK, num_blocks=SLA_BLOCKS,
                                      sched="priority", preempt="spill", kv_dtype=kv, device=DEV)
            spills = checked_spills(engine)
        set_policy(engine, *policy)
        spills.update(spills=0, restores=0, bytes=0)
        captures = engine.metrics()
        captures = (captures["fused_step_compilations"], captures["decode_compilations"])
        first = served_run(label, engine, reqs)
        m = engine.metrics()
        check_graphs(label, m)
        entered = {e[2] for e in engine.event_log if e[0] in ("admit", "resume")}
        for c in first["completions"]:
            if c.finish_reason == "rejected":
                if c.req_class != "batch" or c.request_id in entered:
                    fail(f"{label}: request {c.request_id} ({c.req_class}) rejected after "
                         "admission or not of class batch")
            elif (c.finish_reason != "length"
                  or len(c.new_tokens) != by_id[c.request_id].max_new_tokens):
                fail(f"{label}: request {c.request_id} finished {c.finish_reason} with "
                     f"{len(c.new_tokens)} tokens")
        if len(first["completions"]) != len(reqs) or spills["bad"]:
            fail(f"{label}: {len(first['completions'])} of {len(reqs)} done; spill round trips "
                 f"not bitwise: {spills['bad']}")
        if policy[1] == "spill" and not (spills["spills"] and spills["restores"]):
            fail(f"{label}: no spill round trip ({spills})")
        total = {k: total[k] + first["launches"][k] for k in total}
        spilled = {k: spills[k] for k in ("spills", "bytes")}
        steady, eager = first, {}
        if fresh:  # the run captured its engine's graphs: a reset rerun, equal
            steady = served_run(label, engine, reqs)
            if any(not np.array_equal(t, steady["tokens"][i])
                   for i, t in first["tokens"].items()):
                fail(f"{label}: reset + rerun gave different tokens")
        if label == "sla-shed":  # the eager tick on the same run, bitwise
            eager = eager_against_graphed(label, engine, reqs, first["tokens"],
                                          engine_state(engine))
        m = engine.metrics()
        res[label] = {
            "model_ticks": first["model_ticks"], "first_run_captured": fresh,
            "new_captures": {"fused": m["fused_step_compilations"] - captures[0],
                             "decode": m["decode_compilations"] - captures[1]},
            "first_tokens_per_s": first["tokens_per_s"], "first_mean_tick_ms": first["tick_ms"],
            "steady_tokens_per_s": steady["tokens_per_s"], "steady_mean_tick_ms": steady["tick_ms"],
            "ttft": {k: ttft(steady, k) for k in ("interactive", "batch")},
            **{k: m[k] for k in ("preemptions", "preempt_resumes", "rejections",
                                 "peak_blocks_in_use")},
            "spills": spilled["spills"], "spill_bytes": spilled["bytes"],
            "launches": first["launches"],
            **{k: eager[k] for k in ("eager_mean_tick_ms",) if k in eager}}
        print(f"[{label}] {json.dumps(res[label])}")
    del engine
    torch.cuda.empty_cache()
    # the 2-layer f32 cut: preemption changes no greedy token (one engine,
    # the policy set between runs)
    small, small_master = small_model()
    engine = ContinuousEngine(small, small_master, num_slots=SLOTS, max_seq=max_seq, chunk=CHUNK,
                              block_size=BLOCK, num_blocks=SLA_BLOCKS, sched="priority",
                              device=DEV)
    toks, identity = {}, {}
    for mode in ("off", "recompute", "spill"):
        set_policy(engine, "priority", mode)
        engine.reset()
        comps = engine.run(reqs)
        toks[mode] = {c.request_id: c.new_tokens for c in comps}
        if mode == "off":
            continue
        preempted = [c.request_id for c in comps if c.preemptions]
        same = sum(np.array_equal(toks["off"][i], toks[mode][i]) for i in preempted)
        everyone = sum(np.array_equal(t, toks[mode][i]) for i, t in toks["off"].items())
        identity[mode] = {"preempted_identical": f"{same}/{len(preempted)}",
                          "all_identical": f"{everyone}/{len(reqs)}"}
        if not preempted or same != len(preempted):
            fail(f"sla-2l-{mode}: {same} of {len(preempted)} preempted requests kept the "
                 "preempt-off run's greedy tokens")
    del engine
    torch.cuda.empty_cache()
    print(f"[sla] {json.dumps({'small_f32_identical': identity})}")
    return {"runs": res, "launches": total, "small_f32_identical": identity}


# ------------------------------------------------------------ phases 17-18 --
def recurrent_want(cfg, passes: int, flash: bool = False) -> dict:
    """The launches of ``passes`` passes of an SSM or hybrid model (a slab
    tick, a static prefill or decode step, or a forward with ``flash``):
    ln1 and the mixer's own norm a layer, the hybrid's shared block's two
    norms a group, the head's (2L + 2G + 1, L + 2G - 1 fused: every ln1,
    every shared block's norm but the first one's ln1), and the shared
    attention a group through the softmax (the flash kernel with
    ``flash``); G = 0 for the SSM family."""
    L = cfg.n_layers
    G = L // cfg.attn_every if cfg.family == "hybrid" else 0
    return {"gn_rmsnorm": (2 * L + 2 * G + 1) * passes,
            "gn_rmsnorm_fused": (L + 2 * G - 1) * passes, "gn_paged_attention": 0,
            "gn_paged_attention_int8": 0, "gn_softmax": G * passes * (not flash),
            "gn_attention": G * passes * flash}


def static_want(cfg, passes: int, flash: bool = False) -> dict:
    """The launches of ``passes`` static passes (a prefill or a decode step
    each; a forward with ``flash``): 2L + 1 norms (MLA: 2L more, its
    latents), 2L - 1 of them fused; a softmax a layer for the one-pass
    attention (the flash kernel instead with ``flash``; neither for the
    exact softmax), one more a layer for the MoE router, and a fused norm
    and a softmax a cross-attention block (``cross_blocks``); an SSM or
    hybrid model's as ``recurrent_want``."""
    if cfg.family in ("ssm", "hybrid"):
        return recurrent_want(cfg, passes, flash)
    L, mla, moe = cfg.n_layers, cfg.mla is not None, cfg.moe is not None
    gn, cross = cfg.softmax_impl == "gn", cross_blocks(cfg)
    return {"gn_rmsnorm": (2 * L + 1 + 2 * L * mla + cross) * passes,
            "gn_rmsnorm_fused": (2 * L - 1 + cross) * passes, "gn_paged_attention": 0,
            "gn_paged_attention_int8": 0,
            "gn_softmax": (L * (not flash) * gn + L * moe + cross) * passes,
            "gn_attention": L * passes if flash and gn else 0}


def family_static(label: str, model, params) -> dict:
    """``generate`` over BATCH x PROMPT tokens with NEW new ones (its decode
    step a graph replay), then the teacher-forced ``perplexity`` of the
    outputs' last PROMPT tokens; the launch counters set to 0 before each
    and read after, both exact; finite outputs."""
    data = DataConfig(vocab=model.cfg.vocab, seq_len=PROMPT, global_batch=BATCH, seed=SEED)
    prompts = torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV)
    counters.reset()
    out, gen_ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                         ServeConfig(max_new_tokens=NEW)))
    launches = counters.launch_counts()
    want = static_want(model.cfg, NEW + 1)
    again, steady_ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                              ServeConfig(max_new_tokens=NEW)))
    # the last PROMPT tokens of each output (the 32 new ones among them):
    # BATCH * PROMPT tokens split into whole MoE groups of 2048
    scored = {"tokens": out[:, -PROMPT:].contiguous()}
    counters.reset()
    ppl, ppl_ms = timed(lambda: perplexity(model, params, scored))
    ppl_launches = counters.launch_counts()
    ppl_want = static_want(model.cfg, 1, flash=model.cfg.mla is None)
    if launches != want or ppl_launches != ppl_want:
        fail(f"{label}: static launches {launches} != {want}, or perplexity's "
             f"{ppl_launches} != {ppl_want}")
    if any(counters.plain_cuda_calls().values()):
        fail(f"{label}: plain versions on CUDA tensors: {counters.plain_cuda_calls()}")
    if not torch.equal(again, out) or not math.isfinite(ppl):
        fail(f"{label}: generate's rerun differs, or perplexity {ppl}")
    res = {"batch": BATCH, "prompt": PROMPT, "new_tokens": NEW, "generate_ms": gen_ms,
           "steady_generate_ms": steady_ms,
           "steady_tokens_per_s": BATCH * NEW / (steady_ms / 1e3), "perplexity": ppl,
           "perplexity_ms": ppl_ms, "launches": launches, "perplexity_launches": ppl_launches}
    print(f"[{label}-static] {json.dumps(res)}")
    return {**res, "launches": {k: launches[k] + ppl_launches[k] for k in launches},
            "outputs": out}


def small_identity(label: str, arch: str) -> dict:
    """The 2-layer f32 cut of ``arch`` (full widths) on FAMILY_SMALL's
    workload: the card's engine tokens equal the static oracle's on the card
    (MLA) and the port's CPU engine's on the same weights (both on the
    streamed read, the MoE's dead lanes read alike there); gated."""
    small = make_model(dataclasses.replace(get_config(arch), n_layers=2, dtype="float32"))
    master = small.init(SEED, DEV)
    n, lo, hi, new = FAMILY_SMALL
    reqs = seeded_requests(small.cfg.vocab, n, lo, hi, new, 1, SEED)
    kw = {"num_slots": SLOTS, "max_seq": required_max_seq(reqs), "chunk": CHUNK,
          "block_size": BLOCK}
    clock = [time.perf_counter()]
    with swapped("FORCE_PAGED_READ", "streamed"):
        card = ContinuousEngine(small, master, device=DEV, **kw)
        toks = {c.request_id: c.tokens for c in card.run(reqs)}
        oracle = static_reference(small, card.params, reqs, ServeConfig())
        del card
        clock.append(time.perf_counter())
        # into pinned host memory: a pageable copy of llama4-scout's 25 GB
        # of f32 leaves ran at ~2.2 GB/s
        cpu_master = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                    pin_memory=DEV != "cpu").copy_(t), master)
        del master
        torch.cuda.empty_cache()
        clock.append(time.perf_counter())
        cpu = ContinuousEngine(small, cpu_master, device="cpu", **kw)
        cpu_toks = {c.request_id: c.tokens for c in cpu.run(reqs)}
        clock.append(time.perf_counter())
    same_oracle = sum(np.array_equal(t, oracle[i]) for i, t in toks.items())
    same_cpu = sum(np.array_equal(t, cpu_toks[i]) for i, t in toks.items())
    res = {"oracle_identical": f"{same_oracle}/{n}", "cpu_identical": f"{same_cpu}/{n}",
           "seconds": dict(zip(("card", "to_cpu", "cpu"), np.diff(clock).tolist()))}
    print(f"[{label}-2l-f32] {json.dumps(res)}")
    if same_cpu != n or (small.cfg.moe is None and same_oracle != n):
        fail(f"{label}: at 2 layers f32 the card's engine tokens part from the CPU's or the "
             f"static oracle's: {res}")
    return res


def window_seconds(engine, reqs, start: int, ticks: int) -> float:
    """A reset run of ``reqs`` stopped after model tick ``start + ticks``:
    the host seconds of ticks [start, start + ticks)."""
    engine.reset()
    for req in reqs:
        engine.submit(req)
    while engine.model_ticks < start and engine.step():
        pass

    def window():
        while engine.model_ticks < start + ticks and engine.step():
            pass

    return timed(window)[1] / 1e3


class checked_graphs:
    """Within the block, the first tick of each (step kind, bucket) that
    ``skip(model tick)`` does not exclude runs twice from one device state,
    on every shard: the shard's graph replay, then (its state put back) its
    eager tick.  Their outputs (tokens and health words), the shard's held
    logits, positions and real arena blocks (int8 scales included) must be
    bitwise equal; the run goes on from the eager tick's state.  ``keys``
    lists the (kind, bucket) checked, with the shard index after them on a
    sharded engine; ``eager_ms`` the eager ticks' times and ``seconds`` the
    time the checks added to the run."""

    def __init__(self, label: str, engine, skip):
        self.label, self.engine, self.skip = label, engine, skip
        self.keys, self.eager_ms, self.seconds = [], [], 0.0

    def state(self, d: int) -> dict:
        sh = self.engine.shards[d]
        return {"last_logits": sh._last_logits.clone(), "pos": sh._pos_dev.clone(),
                **{k: v.clone() for k, v in real_leaves(self.engine, d).items()}}

    def restore(self, d: int, state: dict) -> None:
        sh = self.engine.shards[d]
        sh._last_logits.copy_(state["last_logits"])
        sh._pos_dev.copy_(state["pos"])
        for k, v in real_leaves(self.engine, d).items():
            v.copy_(state[k])

    def __enter__(self):
        engine, run = self.engine, self.engine._run_tick

        def checked(kind: str, bucket, d: int = 0):
            key = (kind, bucket) if engine.num_devices == 1 else (kind, bucket, d)
            if key in self.keys or self.skip(engine.model_ticks):
                return run(kind, bucket, d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = self.state(d)
            graphed = run(kind, bucket, d).clone()  # the graph's output buffer is static
            after = self.state(d)
            self.restore(d, before)
            sh = engine.shards[d]
            graphs, sh._graphs = sh._graphs, None
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            try:
                eager = run(kind, bucket, d)
            finally:
                sh._graphs = graphs
            torch.cuda.synchronize()
            self.eager_ms.append((time.perf_counter() - t1) * 1e3)
            now = self.state(d)
            bad = [k for k in after if not torch.equal(after[k], now[k])]
            if not torch.equal(eager, graphed) or bad:
                fail(f"{self.label}: tick {engine.model_ticks} ({kind}, bucket {bucket}, shard "
                     f"{d}) eager differs from its graph: output "
                     f"{torch.equal(eager, graphed)}, state {bad}")
            self.keys.append(key)
            self.seconds += time.perf_counter() - t0
            return eager

        engine._run_tick = checked
        return self

    def __exit__(self, *exc):
        del self.engine._run_tick


KERNEL_KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")), ("gn", ("gn_",)),
                ("index", ("index",)), ("cat", ("Cat",)), ("reduce", ("reduce",)),
                ("elementwise", ("elementwise",)))


def kernel_kinds(per_kernel: dict) -> dict:
    """Device time per kind of kernel name, as shares of the busy time."""
    busy, out = sum(per_kernel.values()), {}
    for name, us in per_kernel.items():
        kind = next((k for k, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + us / busy
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def family_replays(label: str, engine, reqs, first: dict, launches: dict) -> dict:
    """Phase 4's checks at a lean cost for the deep MLA tick:
    ``timed_replay`` (the host clock marked at every model tick); then one
    more rerun in which the first tick of every captured graph runs
    twice, graphed and eager, bitwise (``checked_graphs``), and ticks
    [FAMILY_START, FAMILY_START + FAMILY_WINDOW) are traced, unchecked:
    their busy share against the same ticks of the timed rerun, the GN
    kernels' device records against the window's launches (gated as
    ``want_for``, with the static passes of a fallback in the window).  The
    rerun's tokens and final state must equal the timed rerun's, and every
    captured graph must have been checked."""
    marks = []
    captures, steady_s, m = timed_replay(label, engine, reqs, first, launches, marks=marks)
    state = engine_state(engine)
    ticks = m["model_ticks"]
    start, stop = FAMILY_START, FAMILY_START + FAMILY_WINDOW
    if ticks < stop:
        fail(f"{label}: {ticks} model ticks, fewer than the window's end {stop}")
    base_s = marks[stop] - marks[start]
    res = {"captures": {"fused": captures[0], "decode": captures[1]},
           "capture_seconds": m["capture_seconds"], "steady_seconds": steady_s,
           "steady_tokens_per_s": m["generated_tokens"] / steady_s,
           "steady_mean_tick_ms": float(np.mean([dt * 1e3 for _, _, dt in engine.tick_log]))}
    window = {}

    def rerun():
        engine.reset()
        for req in reqs:
            engine.submit(req)
        with checked_graphs(label, engine, lambda t: start <= t < stop) as checks:
            while engine.model_ticks < start and engine.step():
                pass

            def traced():
                counters.reset()
                admitted = admissions(engine)
                with fallback_passes(engine) as passes:
                    while engine.model_ticks < stop and engine.step():
                        pass
                window.update(launches=counters.launch_counts(), passes=passes,
                              admitted=admissions(engine) - admitted)

            _, prof, seconds = profiled(traced)
            while engine.step():
                pass
        toks = {c.request_id: c.new_tokens for c in engine.completions}
        if any(not np.array_equal(first[i], toks[i]) for i in first):
            fail(f"{label}: the checked rerun gave different tokens")
        window["checks"] = checks
        return toks, prof, seconds

    def want() -> dict:
        expect = want_for(engine, FAMILY_WINDOW, window["passes"], window["admitted"])
        if window["launches"] != expect:
            fail(f"{label}: the window's launches {window['launches']} != {expect}")
        return {name: sum(expect[k] for k in keys) for name, keys in (
            ("gn_paged_attention", ("gn_paged_attention", "gn_paged_attention_int8")),
            ("gn_rmsnorm", ("gn_rmsnorm",)), ("gn_softmax", ("gn_softmax",)),
            ("gn_attention", ("gn_attention",)))}

    _, prof, _, records, traces = traced_rerun(label, rerun, want)
    checks = window["checks"]
    if m["kv_paged"]:
        captured = ({("fused", b) for b in m["fused_buckets"]}
                    | {("decode", b) for b in m["decode_buckets"]})
    else:  # the slab pool: a graph a step kind run
        captured = {(k, None) for k, n in (("fused", m["fused_step_compilations"]),
                                           ("decode", m["decode_compilations"])) if n}
    bad = [k for k, v in state.items() if not torch.equal(v, engine_state(engine)[k])]
    if set(checks.keys) != captured or bad:
        fail(f"{label}: graphs checked against their eager tick {sorted(checks.keys)} != "
             f"captured {sorted(captured)}, or the checked rerun's final {bad} differ")
    per_kernel = _device_us(prof)
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    kinds = kernel_kinds(per_kernel)
    print(f"[{label}-profile] ticks {start}..{stop} of {ticks} traced: device busy "
          f"{busy_s:.4f}s, {100 * busy_s / base_s:.1f}% of the timed rerun's {base_s:.4f}s "
          f"over them; GN kernel records {json.dumps(records)} (trace {traces}); busy share "
          f"by kind: {json.dumps(kinds)}; top kernels (s): "
          + json.dumps({k[:60]: v / 1e6 for k, v in top}))
    res.update(window_ticks=[start, stop], window_seconds=base_s,
               window_mean_tick_ms=base_s / FAMILY_WINDOW * 1e3,
               device_busy_seconds=busy_s, device_busy_share=busy_s / base_s,
               kernel_records=records, busy_share_by_kind=kinds,
               top_kernels_s={k[:60]: v / 1e6 for k, v in top},
               window_fallbacks=len(window["passes"]),
               eager_checked=[f"{k}:{b}" for k, b in checks.keys],
               eager_mean_tick_ms=float(np.mean(checks.eager_ms)),
               eager_check_seconds=checks.seconds)
    return res


def phase_mla(served: dict) -> dict:
    """minicpm3-4b at full width cut to MLA_LAYERS layers (module
    docstring, phase 17)."""
    model = make_model(dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS))
    master = model.init(SEED, DEV)
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    res, total = {}, dict.fromkeys(counters.WRAPPERS, 0)
    params = None
    stages = {}
    for kv in ("fp", "int8"):
        label = f"mla-{kv}"
        t0 = time.perf_counter()
        engine = guard_engine(model, master, reqs, kv_dtype=kv)
        if engine.read_path != "streamed":
            fail(f"{label}: the MLA tick reads through {engine.read_path!r}, not 'streamed'")
        # int8 MLA clips: a request whose latent writes saturate past the
        # watchdog's share finishes on the fp static path
        first, launches, seconds = first_run(label, engine, reqs, fallbacks_ok=kv == "int8")
        stats = serve_stats(engine, seconds)
        fallbacks = engine.metrics()["fallbacks"]
        replays = family_replays(label, engine, reqs, first, launches)
        total = {k: total[k] + launches[k] for k in total}
        per_token = engine.pool.hbm_bytes() / (engine.pool.num_blocks * BLOCK)
        stages[kv] = time.perf_counter() - t0
        # an injected fault over this pool, flagged within a tick and
        # contained, over the workload's first SLOTS requests
        t0 = time.perf_counter()
        chaos = chaos_run(f"{label}-chaos", engine, reqs[:SLOTS],
                          ("nan_tile",) if kv == "fp" else ("scale",),
                          {r.id: first[r.id] for r in reqs[:SLOTS]},
                          faults=FAMILY_FAULTS, fallbacks_ok=kv == "int8")
        stages[f"{kv}-chaos"] = time.perf_counter() - t0
        res[kv] = {**stats, "launches": launches, "fallbacks": fallbacks, **replays,
                   "kv_hbm_bytes": engine.pool.hbm_bytes(),
                   "kv_bytes_per_token": per_token,
                   "kv_bytes_per_token_layer": per_token / model.cfg.n_layers,
                   "chaos_latency_ticks": chaos["latency_ticks"]}
        print(f"[{label}] {json.dumps(res[kv])}")
        if kv == "fp":
            params = engine.params
            # the sentinels' cost a tick: the window's ticks with them off
            # (on its first run: every graph of the window's bucket was
            # captured before it) against the timed rerun's with them on
            t0 = time.perf_counter()
            off = guard_engine(model, master, reqs, sentinels=False)
            ticks = {"on": replays["window_mean_tick_ms"],
                     "off": window_seconds(off, reqs, FAMILY_START, FAMILY_WINDOW)
                     / FAMILY_WINDOW * 1e3}
            res["probe_ms_per_tick"] = ticks["on"] - ticks["off"]
            res["probe_window_tick_ms"] = ticks
            del off
            stages["probe"] = time.perf_counter() - t0
        del engine
        torch.cuda.empty_cache()
    internlm_per_token = served["kv_hbm_bytes"] / (served["num_blocks"] * BLOCK)
    res["internlm2_kv_bytes_per_token"] = internlm_per_token
    # the prefix cache over phase 15's chat workload
    t0 = time.perf_counter()
    chat = shared_prefix_requests(model.cfg, **PREFIX)
    engine = ContinuousEngine(model, master, num_slots=SLOTS, max_seq=required_max_seq(chat),
                              chunk=CHUNK, block_size=BLOCK, prefix_cache=True, device=DEV)
    forks = checked_forks(engine.pool)
    run = served_run("mla-prefix", engine, chat)
    m = engine.metrics()
    check_graphs("mla-prefix", m)
    if not all(forks) or len(forks) != m["prefix_forks"] or not m["prefix_hit_requests"]:
        fail(f"mla-prefix: {forks.count(False)} of {len(forks)} forks not bitwise, "
             f"{m['prefix_hit_requests']} hits")
    total = {k: total[k] + run["launches"][k] for k in total}
    res["prefix"] = {"tokens_per_s": run["tokens_per_s"], "mean_tick_ms": run["tick_ms"],
                     "model_ticks": run["model_ticks"], "ttft": ttft(run),
                     **{k: m[k] for k in ("prefix_hit_rate", "prefix_hit_requests",
                                          "prefix_forks")}}
    print(f"[mla-prefix] {json.dumps(res['prefix'])}")
    del engine, master
    torch.cuda.empty_cache()
    stages["prefix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = family_static("mla", model, params)
    total = {k: total[k] + static["launches"][k] for k in total}
    del params
    model.__dict__.pop("_static_decoders", None)
    torch.cuda.empty_cache()
    res["static"] = {k: static[k] for k in ("steady_tokens_per_s", "steady_generate_ms",
                                            "perplexity", "perplexity_ms")}
    stages["static"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["small_f32"] = small_identity("mla", MLA_ARCH)
    stages["small_f32"] = time.perf_counter() - t0
    res["stage_seconds"] = stages
    keys = ("probe_ms_per_tick", "internlm2_kv_bytes_per_token", "static", "small_f32",
            "stage_seconds")
    print(f"[mla] {json.dumps({k: res[k] for k in keys})}")
    return {**res, "launches": total}


def cast_matmul_leaves(model, master: dict) -> dict:
    """``master`` with its matmul leaves cast to the activation dtype in
    place, one leaf at a time (each f32 leaf freed as its copy replaces it):
    ``prepare`` then casts nothing, and its tree is the one an f32 master
    gives.  The f32 masters of llama4-scout's 4 layers (~42 GB) and their
    bf16 copy do not fit beside a pool on one card at once."""
    dt = getattr(torch, model.cfg.dtype)

    def cast(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                cast(leaf)
            elif key in transformer_mod._MATMUL_LEAVES:
                tree[key] = leaf.to(dt)

    cast(master)
    return master


class routing_log:
    """Within the block, every MoE layer's call records the tick kind (C:
    16 fused, 1 decode), its kept choices' share and the tokens kept per
    expert (the routing computed again beside the layer's own; read after
    the run, so the layer's work is unchanged)."""

    def __enter__(self):
        self.saved, self.calls = moe_mod.apply_moe, []

        def logged(cfg, p, x, group_tokens=0):
            out = self.saved(cfg, p, x, group_tokens)
            r = moe_mod.route(cfg, p, x, group_tokens)
            self.calls.append((x.shape[1], r["keep"].float().mean(),
                               (r["onehot"] * r["keep"][..., None]).sum(dim=(0, 1, 2))))
            return out

        moe_mod.apply_moe = logged
        return self

    def __exit__(self, *exc):
        moe_mod.apply_moe = self.saved

    def summary(self) -> dict:
        out = {}
        for c, kind in ((CHUNK, "fused"), (1, "decode")):
            calls = [(k, e) for cc, k, e in self.calls if cc == c]
            if calls:
                load = torch.stack([e for _, e in calls]).sum(0).float()
                out[kind] = {"layer_calls": len(calls),
                             "dropped_frac": 1.0 - float(torch.stack([k for k, _ in calls]).mean()),
                             "expert_load": (load / load.sum()).tolist()}
        return out


def phase_moe(kern: dict) -> dict:
    """llama4-scout-17b-a16e at full width cut to MOE_LAYERS layers (module
    docstring, phase 18)."""
    t0, stages = time.perf_counter(), {}
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    model = make_model(cfg)
    master = cast_matmul_leaves(model, model.init(SEED, DEV))
    reqs = seeded_requests(cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    engine = guard_engine(model, master, reqs)
    del master
    if engine.read_path != "kernel":
        fail(f"moe: the tick reads through {engine.read_path!r}, not the kernel")
    first, launches, seconds = first_run("moe", engine, reqs)
    stats = serve_stats(engine, seconds)
    with routing_log() as log:  # the eager rerun (last) runs the layers' Python
        replays = continuous_replays("moe", engine, reqs, first, launches, window=MOE_WINDOW)
    routing = log.summary()
    reads = {f"C={r['shape']['C']} {r['name']}": {k: r[k] for k in ("design", "ms", "bound_ms",
                                                                     "plain_ms")}
             for r in kern["gn_paged_attention"] + kern["gn_paged_attention_int8"]
             if r["shape"].get("H") == 40 and "case" not in r}
    res = {**stats, "launches": launches,
           **{k: replays[k] for k in ("steady_tokens_per_s", "steady_mean_tick_ms",
                                      "device_busy_share", "eager_mean_tick_ms", "captures")},
           "routing": routing, "paged_read_group5": reads}
    print(f"[moe] {json.dumps(res)}")
    params = engine.params
    del engine
    torch.cuda.empty_cache()
    stages["continuous"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = family_static("moe", model, params)
    del params
    model.__dict__.pop("_static_decoders", None)
    torch.cuda.empty_cache()
    res["static"] = {k: static[k] for k in ("steady_tokens_per_s", "steady_generate_ms",
                                            "perplexity", "perplexity_ms")}
    stages["static"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["small_f32"] = small_identity("moe", MOE_ARCH)
    stages["small_f32"] = time.perf_counter() - t0
    res["stage_seconds"] = stages
    print(f"[moe-stages] {json.dumps(stages)}")
    total = {k: launches[k] + static["launches"][k] for k in launches}
    return {**res, "launches": total}


# ------------------------------------------------------------ phases 19-20 --
def layerwise_master(model, seed: int) -> dict:
    """Random weights for ``model`` drawn one layer slice at a time from a
    generator seeded with ``seed`` (normal * 0.02, ones, zeros, as
    ``Model.init`` draws them, in another order), the matmul leaves cast to
    the activation dtype as each slice is drawn: at most one layer's f32
    slice of a leaf is resident at once.  ``prepare`` then casts nothing."""
    dt = getattr(torch, model.cfg.dtype)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def build(tree, key=None, stacked=False):
        if isinstance(tree, dict):
            return {k: build(v, k, stacked or k == "layers") for k, v in tree.items()}
        want = dt if key in transformer_mod._MATMUL_LEAVES else torch.float32
        if tree.init != "normal" or not stacked:
            return make_param(tree, gen, DEV).to(want)
        out = torch.empty(tree.shape, dtype=want, device=DEV)
        for i in range(tree.shape[0]):
            out[i] = torch.randn(tree.shape[1:], generator=gen, device=DEV) * tree.scale
        return out

    return build(model.param_specs())


def release() -> None:
    """Free what dead engines held: an engine whose methods a checker
    patched and restored (a bound method stored on itself) or whose pool
    and prefix cache point at each other dies only at a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def slab_engine(model, master, reqs, **kw):
    return ContinuousEngine(model, master, num_slots=SLOTS, max_seq=required_max_seq(reqs),
                            chunk=CHUNK, paged=False, device=DEV, **kw)


def slab_dense(served: dict) -> dict:
    """Phase 19 (a): full-width internlm2-1.8b on the slab pool over phase
    4's workload, with phase 17's lean checks (``family_replays``)."""
    model = make_model(get_config(ARCH))
    master = model.init(SEED, DEV)
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    engine = slab_engine(model, master, reqs)
    del master
    if engine.read_path != "slab" or engine.paged or engine.sentinels:
        fail(f"slab: the engine reads {engine.read_path!r} (paged {engine.paged})")
    first, launches, seconds = first_run("slab", engine, reqs)
    res = {**serve_stats(engine, seconds), "launches": launches,
           **family_replays("slab", engine, reqs, first, launches),
           "kv_hbm_bytes": engine.pool.hbm_bytes(),
           "paged_kv_hbm_bytes": served["kv_hbm_bytes"],
           "common_prefix_with_paged": float(np.mean(common_prefix(first,
                                                                   served["new_tokens"])))}
    print(f"[slab] {json.dumps(res)}")
    return res


def mixtral_static(model, params) -> dict:
    """``generate`` over MIXTRAL_STATIC prompts past the window: the prefill
    through the windowed flash kernel (L launches), then NEW decode steps
    over the ring (a softmax a layer), and a router softmax a layer in
    every pass; launches exact, finite logits."""
    b, s = MIXTRAL_STATIC
    data = DataConfig(vocab=model.cfg.vocab, seq_len=s, global_batch=b, seed=SEED)
    prompts = torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV)
    counters.reset()
    out, ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                     ServeConfig(max_new_tokens=NEW)))
    launches = counters.launch_counts()
    pre, dec = static_want(model.cfg, 1, flash=True), static_want(model.cfg, NEW)
    want = {k: pre[k] + dec[k] for k in pre}
    if launches != want or any(counters.plain_cuda_calls().values()):
        fail(f"mixtral-static: launches {launches} != {want}, or plain versions on the card")
    _, steady_ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                          ServeConfig(max_new_tokens=NEW)))
    res = {"batch": b, "prompt": s, "new_tokens": NEW, "generate_ms": ms,
           "steady_generate_ms": steady_ms, "launches": launches,
           "steady_tokens_per_s": b * NEW / (steady_ms / 1e3)}
    print(f"[mixtral-static] {json.dumps(res)}")
    return res


def slab_mixtral() -> dict:
    """Phase 19 (b): mixtral-8x22b at full width cut to MIXTRAL_LAYERS
    layers on the slab pool (its ring of the window), and its static path
    past the window."""
    t0, stages = time.perf_counter(), {}
    cfg = dataclasses.replace(get_config(MIXTRAL_ARCH), n_layers=MIXTRAL_LAYERS)
    model = make_model(cfg)
    master = layerwise_master(model, SEED)
    reqs = seeded_requests(cfg.vocab, MIXTRAL_REQUESTS, MIXTRAL_PROMPT_MIN, MIXTRAL_PROMPT_MAX,
                           NEW, 1, SEED)
    engine = ContinuousEngine(model, master, num_slots=SLOTS, max_seq=required_max_seq(reqs),
                              chunk=CHUNK, device=DEV)
    del master
    if engine.paged or engine.pool.caches[0]["k"].shape[2] != MIXTRAL_WINDOW:
        fail(f"mixtral: paged {engine.paged}, ring {tuple(engine.pool.caches[0]['k'].shape)}")
    stages["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, launches, seconds = first_run("mixtral", engine, reqs)
    stats = serve_stats(engine, seconds)
    stages["first_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with routing_log() as log:  # the checked rerun's eager ticks run the layers' Python
        replays = family_replays("mixtral", engine, reqs, first, launches)
    wraps = sum(r.prompt_len + NEW > MIXTRAL_WINDOW for r in reqs)
    res = {**stats, "launches": launches,
           **{k: replays[k] for k in ("steady_tokens_per_s", "steady_mean_tick_ms",
                                      "device_busy_share", "eager_mean_tick_ms", "captures",
                                      "busy_share_by_kind", "top_kernels_s")},
           "layers": MIXTRAL_LAYERS, "ring_bytes": engine.pool.hbm_bytes(),
           "requests_wrapping_the_ring": f"{wraps}/{len(reqs)}", "routing": log.summary()}
    print(f"[mixtral] {json.dumps(res)}")
    stages["replays"] = time.perf_counter() - t0
    params = engine.params
    del engine
    release()
    t0 = time.perf_counter()
    static = mixtral_static(model, params)
    del params
    model.__dict__.pop("_static_decoders", None)
    release()
    stages["static"] = time.perf_counter() - t0
    res.update(static={k: static[k] for k in ("steady_tokens_per_s", "steady_generate_ms")},
               stage_seconds=stages)
    print(f"[mixtral-stages] {json.dumps(stages)}")
    return {**res, "launches": {k: launches[k] + static["launches"][k] for k in launches}}


def slab_small(label: str, arch: str, spec: tuple, over: dict) -> dict:
    """Phase 19 (c): the 2-layer f32 cut of ``arch`` (full widths, ``over``
    applied) on ``spec``'s workload (requests, shortest and longest prompt,
    new tokens): the card's slab engine against the static oracle on the
    card, the paged engine on the card (a model whose KV pages) and the
    CPU's slab engine on the same weights.  Gated: the slab engine equals
    the CPU's, and for a dense model the oracle and the paged engine; a MoE
    model's oracle routes a chunk's lanes in other groups (the reference's
    documented exception), so its identity is reported."""
    small = make_model(dataclasses.replace(get_config(arch),
                                           **{"n_layers": 2, "dtype": "float32", **over}))
    master = small.init(SEED, DEV)
    n, lo, hi, new = spec
    reqs = seeded_requests(small.cfg.vocab, n, lo, hi, new, 1, SEED)
    card = slab_engine(small, master, reqs)
    toks = {c.request_id: c.tokens for c in card.run(reqs)}
    oracle = static_reference(small, card.params, reqs, ServeConfig())
    del card
    paged = None
    if small.supports_paging:
        eng = guard_engine(small, master, reqs)
        paged = {c.request_id: c.tokens for c in eng.run(reqs)}
        del eng
    # into pinned host memory, as small_identity copies (pageable ran at ~2 GB/s)
    cpu_master = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=DEV != "cpu").copy_(t), master)
    del master
    torch.cuda.empty_cache()
    cpu = ContinuousEngine(small, cpu_master, num_slots=SLOTS, max_seq=required_max_seq(reqs),
                           chunk=CHUNK, paged=False, device="cpu")
    cpu_toks = {c.request_id: c.tokens for c in cpu.run(reqs)}

    def same(other):
        return None if other is None else sum(np.array_equal(t, other[i])
                                              for i, t in toks.items())

    res = {"oracle_identical": f"{same(oracle)}/{n}", "cpu_identical": f"{same(cpu_toks)}/{n}",
           "paged_identical": None if paged is None else f"{same(paged)}/{n}",
           "wrapping": sum(r.prompt_len + new > (small.cfg.sliding_window or 1 << 30)
                           for r in reqs)}
    print(f"[{label}-2l-f32] {json.dumps(res)}")
    if same(cpu_toks) != n or (small.cfg.moe is None and (
            same(oracle) != n or (paged is not None and same(paged) != n))):
        fail(f"{label}: at 2 layers f32 the slab engine's tokens part: {res}")
    return res


def phase_slab(served: dict) -> dict:
    """Phase 19 (module docstring)."""
    t0, stages = time.perf_counter(), {}
    dense = slab_dense(served)
    release()
    stages["dense"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixtral = slab_mixtral()
    release()
    stages["mixtral"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = {"dense": slab_small("slab", ARCH, FAMILY_SMALL, {})}
    release()
    small["mixtral"] = slab_small("mixtral", MIXTRAL_ARCH, MIXTRAL_SMALL,
                                  {"sliding_window": SMALL_WINDOW})
    release()
    stages["small_f32"] = time.perf_counter() - t0
    print(f"[slab-stages] {json.dumps(stages)}")
    return {"dense": dense, "mixtral": mixtral, "small_f32": small, "stage_seconds": stages,
            "launches": {k: dense["launches"][k] + mixtral["launches"][k]
                         for k in dense["launches"]}}


def fingerprint(engine) -> tuple:
    """What a drain must reproduce: completions (tokens, reason, finish
    step, preemptions), the event log and the step count."""
    return ([(c.request_id, c.new_tokens.tolist(), c.finish_reason, c.finish_step,
              c.preemptions) for c in engine.completions], list(engine.event_log),
            engine.step_count)


def snapshot_sweep(label: str, model, master, reqs, root: Path, at: tuple | None = None,
                   **kw) -> dict:
    """Phase 20 (a): a writer snapshots after every tick (or after model
    ticks ``at``); one restorer, whose graphs a first run captured,
    restores each snapshot and drains; every drain bitwise the writer's
    (``fingerprint``)."""
    mk = functools.partial(ContinuousEngine, model, master, num_slots=SLOTS,
                           max_seq=required_max_seq(reqs), chunk=CHUNK, device=DEV, **kw)
    path = root / label
    writer = mk()
    for r in reqs:
        writer.submit(r)
    steps = []
    while writer.step():
        if at is None or (writer.model_ticks in at and writer.step_count not in steps):
            writer.snapshot(path)
            steps.append(writer.step_count)
    want = fingerprint(writer)
    del writer
    restorer = mk()
    restorer.run(reqs)  # captures its graphs
    captures = restorer.metrics()["fused_step_compilations"]
    bad = []
    for step in steps:
        restorer.restore(path, step)
        while restorer.step():
            pass
        if fingerprint(restorer) != want:
            bad.append(step)
    res = {"snapshots": len(steps), "diverged": bad, "captures_before_restores": captures,
           "captures_after": restorer.metrics()["fused_step_compilations"]}
    print(f"[snapshot-{label}] {json.dumps(res)}")
    if bad or not steps or res["captures_after"] != captures:
        fail(f"snapshot-{label}: drains from ticks {bad} differ from the writer's, or a "
             f"restored engine captured again: {res}")
    return res


def snapshot_full(served: dict, root: Path) -> dict:
    """Phase 20 (b): full-width internlm2-1.8b over phase 4's workload,
    snapshots at SNAP_TICKS, each restored into one fresh engine and
    drained: tokens bitwise the uninterrupted run's (phase 4's); bytes,
    save and restore seconds; the drains' launches exact."""
    model = make_model(get_config(ARCH))
    master = model.init(SEED, DEV)
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    writer = guard_engine(model, master, reqs)
    for r in reqs:
        writer.submit(r)
    saves, path = {}, root / "full"
    while writer.step():
        if writer.model_ticks in SNAP_TICKS and writer.model_ticks not in saves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            where = Path(writer.snapshot(path))
            saves[writer.model_ticks] = {
                "step": writer.step_count, "save_s": time.perf_counter() - t0,
                "bytes": sum(f.stat().st_size for f in where.iterdir())}
    whole = {c.request_id: c.new_tokens for c in writer.completions}
    del writer
    if any(not np.array_equal(whole[i], served["new_tokens"][i]) for i in whole):
        fail("snapshot: the writer's tokens differ from phase 4's")
    restorer = guard_engine(model, master, reqs)
    del master
    launches = dict.fromkeys(counters.WRAPPERS, 0)
    for tick, rec in saves.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restorer.restore(path, rec["step"])
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        counters.reset()
        while restorer.step():
            pass
        got, want = counters.launch_counts(), want_for(restorer,
                                                       restorer.model_ticks - tick)
        launches = {k: launches[k] + got[k] for k in launches}
        toks = {c.request_id: c.new_tokens for c in restorer.completions}
        rec["identical"] = sum(np.array_equal(toks[i], whole[i]) for i in whole)
        if rec["identical"] != len(whole) or got != want:
            fail(f"snapshot: restored at tick {tick}: {rec['identical']}/{len(whole)} requests "
                 f"identical, launches {got} != {want}")
    res = {"ticks": {str(k): v for k, v in saves.items()},
           "restorer_captures": restorer.metrics()["fused_step_compilations"]}
    print(f"[snapshot-full] {json.dumps(res)}")
    return {**res, "launches": launches}


def snapshot_faults(model, master, reqs, root: Path) -> dict:
    """Phase 20 (c): NaN tiles injected until a block is quarantined, a
    snapshot, a restore into a fresh engine: the same quarantined set and
    retry map, the ledger balanced after the restore and every tick of the
    drain, the quarantined blocks never recycled, every request done."""
    mk = functools.partial(guard_engine, model, master, reqs)
    eng = mk()
    inj = FaultInjector(eng, seed=1)
    for r in reqs:
        eng.submit(r)
    injected = 0
    while not eng.pool.quarantined:
        if not eng.step():
            fail("snapshot-faults: drained before any quarantine")
        if injected < 3 and inj.inject("nan_tile"):
            injected += 1
    eng.snapshot(root / "faults")
    quarantined, retries = set(eng.pool.quarantined), dict(eng._fault_retries)
    del eng
    fresh = mk()
    fresh.restore(root / "faults")
    ok = fresh.pool.quarantined == quarantined and fresh._fault_retries == retries
    fresh.pool.check_ledger()
    while fresh.step():
        fresh.pool.check_ledger()
        ok &= quarantined <= fresh.pool.quarantined
    ok &= len(fresh.completions) == len(reqs)
    res = {"quarantined": sorted(quarantined), "retries": retries, "ok": ok,
           "completions": len(fresh.completions)}
    print(f"[snapshot-faults] {json.dumps(res)}")
    if not ok:
        fail(f"snapshot-faults: {res}")
    return res


def phase_snapshot(served: dict) -> dict:
    """Phase 20 (module docstring)."""
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_snap_"))
    t0, stages = time.perf_counter(), {}
    try:
        small = make_model(dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32"))
        master = small.init(SEED, DEV)
        n, lo, hi, new = SNAP_SMALL
        reqs = seeded_requests(small.cfg.vocab, n, lo, hi, new, 1, SEED)
        sweep = {label: snapshot_sweep(label, small, master, reqs, root, **kw)
                 for label, kw in (("paged-fp", {}), ("paged-int8", {"kv_dtype": "int8"}),
                                   ("slab", {"paged": False}))}
        faults = snapshot_faults(small, master, reqs, root)
        del master
        release()
        # whisper at 2 layers f32 (encoder too), its requests' frames and the
        # pool's cross k/v in the snapshots, at three ticks (~0.25 GB each)
        whisper = make_model(dataclasses.replace(get_config(XATTN_ARCHS[0]), n_layers=2,
                                                 encoder_layers=2, dtype="float32"))
        wmaster = whisper.init(SEED, DEV)
        wreqs = with_extras(whisper.cfg, seeded_requests(whisper.cfg.vocab, n, lo, hi, new, 1,
                                                         SEED), SEED)
        sweep["whisper-extras"] = snapshot_sweep("whisper-extras", whisper, wmaster, wreqs, root,
                                                 at=SNAP_EXTRAS_TICKS)
        del wmaster
        release()
        stages["small"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = snapshot_full(served, root)
        stages["full"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[snapshot-stages] {json.dumps(stages)}")
    return {"sweep": sweep, "faults": faults, "full": full, "stage_seconds": stages,
            "launches": full["launches"]}


# ----------------------------------------------------------------- phase 21 --
def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def exact_long() -> dict:
    """Phase 21 (a): full-width internlm2-1.8b with the exact softmax: the
    static prefill and the forward at LONG_EXACT through the chunked stream
    (plain torch; the GN kernels launch only the norms, exactly), ms and
    peak memory; the forward at 1 x 4096 against the one-pass ``_sdpa``
    (``attention._long_exact`` off) at f32, the same function up to f32
    sums, within LOGITS_ATOL_F32 (gated), and at bf16 (reported: the
    one-pass path rounds its scores to bf16 before the softmax, the stream
    takes f32 products, as the reference's two paths do)."""
    cfg = dataclasses.replace(get_config(ARCH), softmax_impl="exact")
    model = make_model(cfg)
    master = model.init(SEED, DEV)
    params = model.prepare(master, DEV)
    out = {}
    for b, s in LONG_EXACT:
        data = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=SEED)
        toks = torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV)
        row = {}
        for name, fn in (("prefill", lambda: model.prefill(params, {"tokens": toks})[0]),
                         ("forward", lambda: model.forward(params, {"tokens": toks}))):
            release()
            torch.cuda.reset_peak_memory_stats()
            counters.reset()
            logits, ms = timed(fn)
            launches = counters.launch_counts()
            finite = bool(torch.isfinite(logits).all())
            del logits
            if launches != static_want(cfg, 1) or any(counters.plain_cuda_calls().values()):
                fail(f"long-exact {b}x{s} {name}: launches {launches} != {static_want(cfg, 1)}")
            if not finite:
                fail(f"long-exact {b}x{s} {name}: nonfinite logits")
            row[name] = {"ms": ms, "tokens_per_s": b * s / (ms / 1e3), "peak_gb": peak_gb()}
        out[f"{b}x{s}"] = row
    release()
    toks = torch.as_tensor(batch_at(DataConfig(vocab=cfg.vocab, seq_len=4096, global_batch=1,
                                               seed=SEED + 1), 0)["tokens"]).to(DEV)
    gate = {}
    for dtype in ("bfloat16", "float32"):
        m = make_model(dataclasses.replace(cfg, dtype=dtype))
        p = params if dtype == cfg.dtype else m.prepare(master, DEV)
        chunked = m.forward(p, {"tokens": toks}).float()
        release()
        torch.cuda.reset_peak_memory_stats()
        with swapped("_long_exact", lambda cfg, s: False):
            one_pass, one_ms = timed(lambda: m.forward(p, {"tokens": toks}).float())
        gate[dtype] = {
            "max_abs_err": (chunked - one_pass).abs().max().item(),
            "argmax_agreement": (chunked.argmax(-1) == one_pass.argmax(-1)).float().mean().item(),
            "one_pass_ms": one_ms, "one_pass_peak_gb": peak_gb()}
        del chunked, one_pass, p
        release()
    del params, master
    release()
    res = {"runs": out, "against_one_pass_1x4096": gate, "atol_f32": LOGITS_ATOL_F32}
    print(f"[long-exact] {json.dumps(res)}")
    if gate["float32"]["max_abs_err"] > LOGITS_ATOL_F32:
        fail(f"long-exact: at f32 the chunked forward parts from the one-pass forward: {gate}")
    return res


def mla_long() -> dict:
    """Phase 21 (b): minicpm3-4b at full width and depth: ``generate`` over
    MLA_LONG prompts (the prefill past 2048 through the flash kernel at the
    padded head dim, a launch a layer; NEW decode steps through the softmax
    kernel), then ``perplexity`` over the outputs' last MLA_LONG tokens (the
    forward's flash launches); launches exact, finite."""
    model = make_model(get_config(MLA_ARCH))
    params = model.prepare(layerwise_master(model, SEED), DEV)
    b, s = MLA_LONG
    data = DataConfig(vocab=model.cfg.vocab, seq_len=s, global_batch=b, seed=SEED)
    prompts = torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out, gen_ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                         ServeConfig(max_new_tokens=NEW)))
    launches = counters.launch_counts()
    want = add_launches(static_want(model.cfg, 1, flash=True), static_want(model.cfg, NEW))
    gen_peak = peak_gb()
    again, steady_ms = timed(lambda: generate(model, params, {"tokens": prompts},
                                              ServeConfig(max_new_tokens=NEW)))
    model.__dict__.pop("_static_decoders", None)
    release()
    scored = {"tokens": out[:, -s:].contiguous()}
    counters.reset()
    ppl, ppl_ms = timed(lambda: perplexity(model, params, scored))
    ppl_launches = counters.launch_counts()
    ppl_want = static_want(model.cfg, 1, flash=True)
    res = {"batch": b, "prompt": s, "new_tokens": NEW, "generate_ms": gen_ms,
           "steady_generate_ms": steady_ms, "generate_peak_gb": gen_peak,
           "flash_launches": launches["gn_attention"], "perplexity": ppl,
           "perplexity_ms": ppl_ms, "launches": launches, "perplexity_launches": ppl_launches}
    print(f"[long-mla] {json.dumps(res)}")
    if (launches != want or ppl_launches != ppl_want
            or any(counters.plain_cuda_calls().values())):
        fail(f"long-mla: launches {launches} != {want}, or perplexity's {ppl_launches} != "
             f"{ppl_want}, or plain versions on the card")
    if not torch.equal(again, out) or not math.isfinite(ppl):
        fail(f"long-mla: generate's rerun differs, or perplexity {ppl}")
    del params
    release()
    return {**res, "launches": add_launches(launches, ppl_launches)}


def train_long() -> dict:
    """Phase 21 (c): full-width, full-depth internlm2-1.8b trained at
    TRAIN_LONG: bf16 compute over f32 masters, the flash kernel's
    straight-through backward past 2048; launches exact (no softmax in the
    backward there: it is plain), losses and grad norms finite; ms a step,
    tokens/s, peak memory; then ``launch.train --smoke --seq 4096`` as a
    subprocess on the card."""
    b, s, mb, steps = TRAIN_LONG
    model = make_model(get_config(ARCH))
    params = model.init(SEED, DEV)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    state, step = init_opt_state(opt, params), make_train_step(model, opt, mb)
    batch = batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=s, global_batch=b, seed=SEED), 0)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    ms, losses = [], []
    for _ in range(steps):
        (params, state, m), t = timed(lambda: step(params, state, batch))
        ms.append(t)
        losses.append(float(m["loss"]))
        if not (math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"]))):
            fail(f"train-long: nonfinite loss or grad norm {m}")
    launches = counters.launch_counts()
    want = train_want(model.cfg.n_layers, steps * mb)
    want["gn_softmax"] = 0  # past 2048 the backward's softmax is the plain closed form
    res = {"batch": b, "seq": s, "microbatches": mb, "steps": steps, "layers": model.cfg.n_layers,
           "step_ms": ms, "steady_step_ms": float(np.median(ms[1:])),
           "tokens_per_s": b * s / (float(np.median(ms[1:])) / 1e3), "losses": losses,
           "peak_gb": peak_gb(), "launches": launches}
    del params, state
    release()
    if launches != want or any(counters.plain_cuda_calls().values()):
        fail(f"train-long: launches {launches} != {want}, or plain versions on the card")
    # started with phase 12's launchers (``launched``)
    run = launch_result("train-long")["train-long"]
    res["launcher"] = {"rc": run["rc"], "seconds": run["seconds"], "last_line": run["last_line"]}
    print(f"[train-long] {json.dumps(res)}")
    if run["rc"]:
        fail(f"train-long: launch.train --seq {s} exited {run['rc']}: {run['stderr'][-2000:]}")
    return res


def long_small_card() -> tuple:
    """Phase 21 (d), its card half, run first so that its CPU half
    (``long_small_cpu``) runs beside phase 21's card stages: internlm2-1.8b
    cut to 2 layers at f32 (full widths), the prefill over 1 x LONG_SMALL
    tokens on the card, exact (the chunked stream) and GN (the flash
    kernel); the GN flash kernel's straight-through gradients at (1, 16, 8,
    LONG_SMALL, 128).  Returns (the card's logits and gradients, the CPU
    half's inputs: each impl's model, CPU masters and tokens, and the
    attention inputs on the CPU)."""
    card, cpu_in = {}, {}
    for impl in ("gn", "exact"):
        small = make_model(dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32",
                                               softmax_impl=impl))
        master = small.init(SEED, DEV)
        data = DataConfig(vocab=small.cfg.vocab, seq_len=LONG_SMALL, global_batch=1, seed=SEED)
        toks = torch.as_tensor(batch_at(data, 0)["tokens"])
        card[impl] = small.prefill(small.prepare(master, DEV), {"tokens": toks.to(DEV)})[0][0].cpu()
        cpu_in[impl] = (small, tree_map(lambda t: t.cpu(), master), toks)
        del master
        release()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    q, k, v = fa_inputs((1, 16, 8, LONG_SMALL, LONG_SMALL, 128), torch.float32, gen)
    w = torch.randn(q.shape, generator=gen, device=DEV)
    card["grads"] = st_grads(q, k, v, w, DEV)
    cpu_in["attention"] = [t.cpu() for t in (q, k, v, w)]
    return card, cpu_in


def st_grads(q, k, v, w, dev) -> list:
    """The GN flash attention's straight-through gradients of sum(out * w)
    (causal) with respect to q, k and v, computed on ``dev``, on the CPU."""
    ts = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
    (fa_ops.gn_attention(*ts, causal=True) * w.to(dev)).sum().backward()
    return [t.grad.cpu() for t in ts]


def long_small_cpu(cpu_in: dict) -> dict:
    """Phase 21 (d), its CPU half: the same prefills and gradients on the
    CPU (the plain one-pass GN version, the chunked exact stream)."""
    out = {}
    for impl in ("gn", "exact"):
        small, cpu_master, toks = cpu_in[impl]
        out[impl] = small.prefill(small.prepare(cpu_master, "cpu"), {"tokens": toks})[0][0]
    out["grads"] = st_grads(*cpu_in["attention"], "cpu")
    return out


def long_small(card: dict, cpu: dict) -> dict:
    """Phase 21 (d): the card's 2-layer f32 prefills and gradients
    (``long_small_card``) against the CPU's (``long_small_cpu``).  Gated as
    phase 2 gates the kernel against its plain version: the positions whose
    logits part by more than LOGITS_ATOL_F32 at most FLIP_ROWS of all (a
    Δ-grid flip on a score row moves that position's logits), none past
    LOGITS_ATOL_BF16, and the next token equal unless the CPU's top two
    logits lie within twice the measured gap (a near tie, reported); the
    gradients within GRAD_REL["attention_float32"] relative L2 (gated)."""
    res, ok = {}, True
    for impl in ("gn", "exact"):
        row_err = (card[impl] - cpu[impl]).abs().amax(dim=-1)
        err = row_err.max().item()
        past = (row_err > LOGITS_ATOL_F32).float().mean().item()
        top2 = cpu[impl][-1].topk(2).values
        margin = (top2[0] - top2[1]).item()
        same = int(card[impl][-1].argmax()) == int(cpu[impl][-1].argmax())
        res[impl] = {"max_abs_err": err, "rows_past_atol": past, "last_row_err": row_err[-1].item(),
                     "next_token_equal": same, "cpu_top2_margin": margin}
        ok &= (past <= FLIP_ROWS and err <= LOGITS_ATOL_BF16
               and (same or margin <= 2 * row_err[-1].item()))
    errs = [rel_l2(a, b) for a, b in zip(card["grads"], cpu["grads"])]
    res["ste_grad_rel_l2"] = errs
    print(f"[long-2l-f32] {json.dumps(res)}")
    if not ok or max(errs) > GRAD_REL["attention_float32"]:
        fail(f"long-2l-f32: the card parts from the CPU past 2048 tokens: {res}")
    return res


def phase_long_chunked() -> dict:
    """Phase 21 (module docstring).  The 2-layer f32 gate's CPU half runs in
    a thread beside the card stages (exact, MLA, training)."""
    t0, stages = time.perf_counter(), {}
    card, cpu_in = long_small_card()
    stages["small_f32_card"] = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        cpu = pool.submit(long_small_cpu, cpu_in)
        del cpu_in
        t0 = time.perf_counter()
        exact = exact_long()
        stages["exact"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mla = mla_long()
        stages["mla"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = train_long()
        stages["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = long_small(card, cpu.result())
        stages["small_f32_wait"] = time.perf_counter() - t0
    print(f"[long-chunked-stages] {json.dumps(stages)}")
    return {"exact": exact, "mla": mla, "train": train, "small_f32": small,
            "stage_seconds": stages,
            "launches": add_launches(mla["launches"], train["launches"])}


# ----------------------------------------------------------------- phase 22 --
def with_extras(cfg, reqs: list, seed: int) -> list:
    """``reqs`` each given seeded frames (encdec, encoder_seq x D) or
    patches (VLM, num_patches x D), f32 N(0, 1)."""
    rng = np.random.default_rng(seed)
    key, shape = (("frames", (cfg.encoder_seq, cfg.d_model)) if cfg.family == "encdec"
                  else ("patches", (cfg.num_patches, cfg.d_model)))
    for r in reqs:
        r.extras = {key: rng.standard_normal(shape, dtype=np.float32)}
    return reqs


def encoder_ms(model, params, req, iters: int = 3) -> float:
    """Host ms of one admission's side inputs (``model.request_extras``:
    whisper's encoder and every layer's cross projection, or the VLM's
    patch cast), synchronized."""
    model.request_extras(params, req.extras)
    return float(np.mean([timed(lambda: model.request_extras(params, req.extras))[1]
                          for _ in range(iters)]))


def xattn_static(label: str, model, params, reqs) -> dict:
    """``generate`` over BATCH x PROMPT tokens with the first BATCH requests'
    frames or patches (the prefill encodes once), NEW new tokens, its rerun
    equal; then ``perplexity`` of the outputs (a flash forward); launches
    exact, finite."""
    cfg = model.cfg
    data = DataConfig(vocab=cfg.vocab, seq_len=PROMPT, global_batch=BATCH, seed=SEED)
    key = next(iter(reqs[0].extras))
    side = {key: torch.from_numpy(np.stack([r.extras[key] for r in reqs[:BATCH]])).to(DEV)}
    batch = {"tokens": torch.as_tensor(batch_at(data, 0)["tokens"]).to(DEV), **side}
    counters.reset()
    out, gen_ms = timed(lambda: generate(model, params, batch, ServeConfig(max_new_tokens=NEW)))
    launches = counters.launch_counts()
    want = add_launches(static_want(cfg, NEW + 1), encoder_want(cfg, 1))
    again, steady_ms = timed(lambda: generate(model, params, batch,
                                              ServeConfig(max_new_tokens=NEW)))
    model.__dict__.pop("_static_decoders", None)
    release()
    counters.reset()
    ppl, ppl_ms = timed(lambda: perplexity(model, params, {**side, "tokens": out}))
    ppl_launches = counters.launch_counts()
    ppl_want = add_launches(static_want(cfg, 1, flash=True), encoder_want(cfg, 1))
    res = {"batch": BATCH, "prompt": PROMPT, "new_tokens": NEW, "generate_ms": gen_ms,
           "steady_generate_ms": steady_ms,
           "steady_tokens_per_s": BATCH * NEW / (steady_ms / 1e3), "perplexity": ppl,
           "perplexity_ms": ppl_ms, "launches": launches}
    print(f"[{label}-static] {json.dumps(res)}")
    if (launches != want or ppl_launches != ppl_want
            or any(counters.plain_cuda_calls().values())):
        fail(f"{label}-static: launches {launches} != {want}, or perplexity's {ppl_launches} "
             f"!= {ppl_want}, or plain versions on the card")
    if not torch.equal(again, out) or not math.isfinite(ppl):
        fail(f"{label}-static: generate's rerun differs, or perplexity {ppl}")
    return {**res, "launches": add_launches(launches, ppl_launches)}


def xattn_small(label: str, arch: str) -> dict:
    """The 2-layer f32 cut of ``arch`` (full widths; whisper's encoder cut
    to 2 layers, the VLM to one block over XATTN_SMALL_PATCHES patches, its
    gate XATTN_GATE) on XATTN_SMALL's workload with seeded extras: over the
    paged and the slab pool, the card's engine tokens equal the static
    oracle's on the card and the CPU engine's on the same weights (gated)."""
    over = {"n_layers": 2, "dtype": "float32"}
    if arch == XATTN_ARCHS[0]:
        over["encoder_layers"] = 2
    else:
        over.update(cross_attn_every=2, num_patches=XATTN_SMALL_PATCHES)
    small = make_model(dataclasses.replace(get_config(arch), **over))
    master = small.init(SEED, DEV)
    if "xattn_layers" in master:
        master["xattn_layers"]["gate"].fill_(XATTN_GATE)
    n, lo, hi, new = XATTN_SMALL
    reqs = with_extras(small.cfg, seeded_requests(small.cfg.vocab, n, lo, hi, new, 1, SEED), SEED)
    cpu_master = tree_map(lambda t: t.cpu(), master)
    res, ok = {}, True
    for pool, kw in (("paged", {}), ("slab", {"paged": False})):
        card = guard_engine(small, master, reqs) if not kw else slab_engine(small, master, reqs)
        toks = {c.request_id: c.tokens for c in card.run(reqs)}
        oracle = static_reference(small, card.params, reqs, ServeConfig())
        del card
        cpu = ContinuousEngine(small, cpu_master, num_slots=SLOTS,
                               max_seq=required_max_seq(reqs), chunk=CHUNK, device="cpu",
                               **({"block_size": BLOCK} if not kw else kw))
        cpu_toks = {c.request_id: c.tokens for c in cpu.run(reqs)}
        same_oracle = sum(np.array_equal(t, oracle[i]) for i, t in toks.items())
        same_cpu = sum(np.array_equal(t, cpu_toks[i]) for i, t in toks.items())
        res[pool] = {"oracle_identical": f"{same_oracle}/{n}", "cpu_identical": f"{same_cpu}/{n}"}
        ok &= same_oracle == n == same_cpu
    del master
    release()
    print(f"[{label}-2l-f32] {json.dumps(res)}")
    if not ok:
        fail(f"{label}: at 2 layers f32 the engines part from the oracle or the CPU: {res}")
    return res


def xattn_family(label: str, arch: str) -> dict:
    """Phase 22 for one family at full width cut to XATTN_DEPTH (module
    docstring)."""
    t0, stages = time.perf_counter(), {}
    model = make_model(dataclasses.replace(get_config(arch), **XATTN_DEPTH[arch]))
    master = layerwise_master(model, SEED)
    if "xattn_layers" in master:
        master["xattn_layers"]["gate"].fill_(XATTN_GATE)
    reqs = with_extras(model.cfg, seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT,
                                                  MAX_PROMPT, NEW, 1, SEED), SEED)
    stages["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = guard_engine(model, master, reqs)
    if engine.read_path != "kernel":
        fail(f"{label}: the tick reads through {engine.read_path!r}, not the kernel")
    first, launches, seconds = first_run(label, engine, reqs)
    res = {"paged_fp": {**serve_stats(engine, seconds),
                        **family_replays(label, engine, reqs, first, launches),
                        "hbm_bytes": engine.pool.hbm_bytes(),
                        "extras_bytes": sum(t.numel() * t.element_size()
                                            for t in engine.pool.extras_shards[0].values()),
                        "encoder_ms_per_admission": encoder_ms(model, engine.params, reqs[0])}}
    total = launches
    params = engine.params
    del engine
    release()
    stages["paged_fp"] = time.perf_counter() - t0
    for pool, kw in (("paged_int8", {"kv_dtype": "int8"}), ("slab", {"paged": False})):
        t0 = time.perf_counter()
        engine = (guard_engine(model, master, reqs, **kw) if pool != "slab"
                  else slab_engine(model, master, reqs))
        toks, launches, seconds = first_run(f"{label}-{pool}", engine, reqs, fallbacks_ok=True)
        captures, steady_s, m = timed_replay(f"{label}-{pool}", engine, reqs, toks, launches)
        res[pool] = {**serve_stats(engine, seconds), "captures": captures,
                     "steady_tokens_per_s": m["generated_tokens"] / steady_s,
                     "steady_mean_tick_ms": float(np.mean([dt * 1e3
                                                           for _, _, dt in engine.tick_log])),
                     "hbm_bytes": engine.pool.hbm_bytes(),
                     "common_prefix_with_paged_fp": float(np.mean(common_prefix(toks, first)))}
        total = add_launches(total, launches)
        del engine
        release()
        stages[pool] = time.perf_counter() - t0
    del master
    t0 = time.perf_counter()
    static = xattn_static(label, model, params, reqs)
    res["static"] = {k: static[k] for k in ("steady_tokens_per_s", "steady_generate_ms",
                                            "perplexity", "perplexity_ms")}
    del params
    release()
    stages["static"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["small_f32"] = xattn_small(label, arch)
    stages["small_f32"] = time.perf_counter() - t0
    res["stage_seconds"] = stages
    print(f"[{label}] {json.dumps(res)}")
    return {**res, "launches": add_launches(total, static["launches"])}


def phase_cross() -> dict:
    """Phase 22 (module docstring)."""
    out = {}
    for label, arch in zip(("whisper", "vlm"), XATTN_ARCHS):
        out[label] = xattn_family(label, arch)
        release()
    return {**out, "launches": add_launches(*(v["launches"] for v in out.values()))}


# ----------------------------------------------------------------- phase 23 --
def ssm_oracle(engine, static_out) -> dict:
    """The continuous engine (reset, its graphs kept) over the static path's
    BATCH prompts of PROMPT tokens, NEW new tokens each: each request's
    share of new tokens in common with ``generate``'s (reported, not gated:
    the static prefill of 1024 = 4 x 256 tokens takes the chunked forms and
    the grouped conv, the tick the per-token recurrence and the shift-add
    conv)."""
    prompts = static_out[:, :PROMPT].cpu().numpy()
    reqs = [Request(tokens=prompts[i], max_new_tokens=NEW, id=i) for i in range(len(prompts))]
    engine.reset()
    comps, ms = timed(lambda: engine.run(reqs))
    ref = {i: row for i, row in enumerate(static_out[:, PROMPT:].cpu().numpy())}
    share = common_prefix({c.request_id: c.new_tokens for c in comps}, ref)
    return {"requests": len(reqs), "prompt": PROMPT, "common_prefix": share,
            "mean_common_prefix": float(np.mean(share)), "seconds": ms / 1e3}


def ssm_train(label: str, arch: str) -> dict:
    """AdamW steps of TRAIN_BATCH x TRAIN_SEQ tokens (1024 = 4 x 256: the
    chunked forms and the grouped conv) in TRAIN_MB microbatches, bf16 over
    f32 masters; zamba2 cut to SSM_TRAIN_GROUPS group of attn_every layers
    (its optimizer state at full depth would not fit).  Gated: launches
    exact (``recurrent_want`` a forward with the flash kernel, and the flash
    backward's softmax a group), no plain version on the card, every loss
    and grad_norm finite.  Reported: losses, ms a step, tokens/s, peak
    memory."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_every * SSM_TRAIN_GROUPS)
    model = make_model(cfg)
    opt = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=SSM_TRAIN_STEPS + 2)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(SEED, DEV)
    state = init_opt_state(opt, params)
    batch = train_batch(cfg.vocab)
    step = make_train_step(model, opt, TRAIN_MB)
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    counters.reset()
    for _ in range(SSM_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    launches, plain = counters.launch_counts(), counters.plain_cuda_calls()
    passes = TRAIN_MB * SSM_TRAIN_STEPS
    want = recurrent_want(cfg, passes, flash=True)
    want["gn_softmax"] += want["gn_attention"]  # the flash backward's recompute
    if launches != want or any(plain.values()):
        fail(f"{label}-train: launches {launches} != {want}, plain {plain}")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{label}-train: nonfinite loss or grad_norm: {losses}, {norms}")
    # causality of the trained model's forward over CAUSAL_LEN tokens (the
    # chunked forms, the grouped conv, the flash kernel): a token changed at
    # CAUSAL_AT leaves every earlier position's logits as they were
    with torch.no_grad():
        fwd = model.prepare(params, DEV)
        toks = torch.as_tensor(batch["tokens"][:1, :CAUSAL_LEN]).to(DEV)
        a = model.forward(fwd, {"tokens": toks}).float()
        toks[:, CAUSAL_AT] = (toks[:, CAUSAL_AT] + 1) % cfg.vocab
        b = model.forward(fwd, {"tokens": toks}).float()
        causal = {"before": (a[:, :CAUSAL_AT] - b[:, :CAUSAL_AT]).abs().max().item(),
                  "at": (a[:, CAUSAL_AT] - b[:, CAUSAL_AT]).abs().max().item()}
        del fwd, a, b
    if not causal["before"] <= CAUSAL_ATOL:
        fail(f"{label}-train: a token at {CAUSAL_AT} moved earlier logits: {causal}")
    steady = step_ms[1:]
    res = {"layers": cfg.n_layers, "params": sum(t.numel() for t in tree_leaves(params)),
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "microbatches": TRAIN_MB, "losses": losses,
           "grad_norms": norms, "first_step_ms": step_ms[0], "step_ms": steady,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (float(np.mean(steady)) / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), "causal_logit_diff": causal,
           "launches": launches}
    print(f"[{label}-train] {json.dumps(res)}")
    del params, state
    return res


def ssm_snapshot(label: str, arch: str, root: Path) -> dict:
    """Phase 20 (a) for the family: at 2 layers f32 (zamba2 in 2 groups at
    cadence 2), snapshots of the carries (and the shared K/V) at model
    ticks SNAP_EXTRAS_TICKS, each restored into one engine whose graphs a
    run captured and drained bitwise the writer."""
    small = make_model(dataclasses.replace(
        get_config(arch), **{"n_layers": 2, "dtype": "float32", **SSM_SMALL[arch]}))
    n, lo, hi, new = SNAP_SMALL
    reqs = seeded_requests(small.cfg.vocab, n, lo, hi, new, 1, SEED)
    return snapshot_sweep(label, small, small.init(SEED, DEV), reqs, root, at=SNAP_EXTRAS_TICKS)


def ssm_family(label: str, arch: str, root: Path) -> dict:
    """Phase 23 for one family at full width, SSM_DEPTH layers (module
    docstring)."""
    t0, stages = time.perf_counter(), {}
    model = make_model(dataclasses.replace(get_config(arch), n_layers=SSM_DEPTH[arch]))
    master = layerwise_master(model, SEED)
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    # max_seq also covers the static path's prompts, which ssm_oracle serves
    engine = ContinuousEngine(model, master, num_slots=SLOTS, chunk=CHUNK, device=DEV,
                              max_seq=max(required_max_seq(reqs), PROMPT + NEW))
    del master
    if engine.paged or engine.read_path != "slab" or engine.sentinels:
        fail(f"{label}: the engine reads {engine.read_path!r} (paged {engine.paged})")
    stages["weights"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, launches, seconds = first_run(label, engine, reqs)
    stats = serve_stats(engine, seconds)
    stages["first_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    replays = family_replays(label, engine, reqs, first, launches)
    carries = set(model.carry_leaves)
    res = {**stats, **replays, "launches": launches, "hbm_bytes": engine.pool.hbm_bytes(),
           "carry_bytes": sum(t.numel() * t.element_size()
                              for k, t in engine.pool.caches[0].items() if k in carries)}
    stages["replays"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = family_static(label, model, engine.params)
    res["static"] = {k: static[k] for k in ("steady_tokens_per_s", "steady_generate_ms",
                                            "generate_ms", "perplexity", "perplexity_ms")}
    model.__dict__.pop("_static_decoders", None)
    stages["static"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["oracle"] = ssm_oracle(engine, static.pop("outputs"))
    del engine
    release()
    stages["oracle"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["small_f32"] = slab_small(label, arch, FAMILY_SMALL, SSM_SMALL[arch])
    release()
    res["snapshot"] = ssm_snapshot(label, arch, root)
    release()
    stages["small_f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = ssm_train(label, arch)
    res["train"] = {k: v for k, v in train.items() if k != "launches"}
    release()
    stages["train"] = time.perf_counter() - t0
    res["stage_seconds"] = stages
    print(f"[{label}] {json.dumps(res)}")
    return {**res, "launches": add_launches(launches, static["launches"], train["launches"])}


def phase_ssm() -> dict:
    """Phase 23 (module docstring)."""
    out = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ssm_"))
    try:
        for label, arch in zip(("xlstm", "zamba2"), SSM_ARCHS):
            out[label] = ssm_family(label, arch, root)
            release()
        # started with phase 12's launchers (``launched``)
        run = launch_result("ssm-train")["ssm-train"]
        out["train_launcher"] = {k: run[k] for k in ("rc", "seconds", "last_line")}
        print(f"[ssm-train-launcher] {json.dumps(out['train_launcher'])}")
        if run["rc"]:
            fail(f"ssm: launch.train --arch {SSM_ARCHS[0]} exited {run['rc']}:\n"
                 f"{run['stdout'][-2000:]}\n{run['stderr'][-2000:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {**out, "launches": {"ssm": out["xlstm"]["launches"],
                                "hybrid": out["zamba2"]["launches"]}}


# ----------------------------------------------------------------- phase 24 --
AUDIT_TRACES = 5  # profiled windows taken until one holds every GN kernel's records


def phase_audit(served: dict, int8: dict) -> dict:
    """Phase 24 (``[audit]``, ``[roofline]``), run right after phase 6 on its
    engines: the invariant auditor (``repro_torch.analysis.audit``) over phase
    4's full-width engine (fp arenas, sentinels on) and phase 6's int8 engine
    as their runs left them (nothing is built): the trace keys against the
    captures, then one eager call of each entry point under the op recorder
    (the tick at every (step kind, bucket) it captured, every lane parked;
    the sentinel step; the prefix fork), every audit rule on each; the
    self-check of every rule's fixtures; then ``profile_cell``'s core over
    phase 4's steady ticks: one eager tick's work (``op_cost``, each GN
    kernel's ``work()``) and a profiled window of LONG_WINDOW replayed ticks
    with each GN kernel's device time beside its bound, taken again (up to
    AUDIT_TRACES times) until its trace holds every GN kernel's records, in
    which the tick's one device-to-host copy is counted: exactly one a tick
    (A-TRANSFER's boundary on the card).  Fatal on any audit error, a
    fixture that does not bite, a window that lost records in every trace,
    or another copy count.  Drops both engines."""
    card = roofline.card()
    out = {"card": str(card)}
    engines = {label: res.pop("_engine") for label, res in (("fp", served), ("int8", int8))}
    t0 = time.perf_counter()
    for label, (engine, _) in engines.items():
        findings = audit.audit_engine(engine, f"{ARCH}:{label}")
        errors = [f.format() for f in findings if f.severity == "error"]
        if errors:
            fail(f"[audit] {label}: {len(errors)} errors\n" + "\n".join(errors))
        out[label] = {"entry_points": [ep.name for ep in audit.collect_entry_points(engine)],
                      "findings": len(findings), "read_path": engine.read_path,
                      "gather_budget": audit.read_budget(engine)[0]}
    out["audit_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    findings, results = run_self_check()
    if findings or any(v != "ok" for v in results.values()):
        fail(f"[audit] self-check: {results}: " + "; ".join(f.format() for f in findings))
    out["self_check"] = {"rules": len(results), "seconds": time.perf_counter() - t0}
    print(f"[audit] {json.dumps(out)}")

    engine, reqs = engines.pop("fp")
    del engines
    t0 = time.perf_counter()
    cell = profile_cell.engine_cell(f"{ARCH} continuous ({engine.model.cfg.n_layers} layers, "
                                    "fp KV, sentinels on)", engine, reqs, LONG_WINDOW)
    prof = profile_cell.profile(cell, LONG_WINDOW, top=12, attempts=AUDIT_TRACES)
    window = prof.pop("window")
    if window["records"] != window["launches"]:
        fail(f"[roofline] every one of {window['traces']} traces lost GN kernel records: "
             f"{window['records']} against launches {window['launches']}")
    copies = audit.memcpy_records(window["prof"])
    if copies.get("DtoH", 0) != LONG_WINDOW:
        fail(f"[roofline] {copies.get('DtoH', 0)} device-to-host copies in {LONG_WINDOW} "
             f"replayed ticks, want one a tick: {copies}")
    res = {**prof, "card": str(card), "memcpy_records": copies, "traces": window["traces"],
           "gn_records": window["records"], "seconds": time.perf_counter() - t0}
    print(f"[roofline] {json.dumps(res)}")
    return {"audit": out, "roofline": res}


# ----------------------------------------------------------------- phase 25 --
SHARDS = 2
SHARD_SMALL = (12, 16, 96, 8)  # the 2-layer f32 cut's workload: n, prompt lo..hi, new
# the full-width bf16 probe: the first SHARD_PROBE_TICKS ticks of one device
# and of the shards in lockstep; a held-logits row of the shards may differ
# from one device's by at most SHARD_LOGIT_RTOL of the row's largest |logit|
# (16 bf16 steps at the row's top: the shards' GEMMs and paged-read splits
# round otherwise than the whole pool's, never by more)
SHARD_PROBE_TICKS, SHARD_LOGIT_RTOL = 16, 2.0 ** -4


def shard_placement() -> tuple:
    """(``device`` for the engine, a label): one card a shard where the
    machine has SHARDS cards, else every shard on cuda:0."""
    if torch.cuda.device_count() >= SHARDS:
        return None, f"{SHARDS} cards"
    return "cuda:0", f"{SHARDS} shards of cuda:0 (the machine has one card)"


def held_agreement(label: str, one, two, reqs, ticks: int) -> dict:
    """``one`` (a one-device engine, eager) and ``two`` (the shards) from a
    reset through their first ``ticks`` model ticks in lockstep: after each
    tick, each request live in both with the same tokens so far holds a
    logits row in each.  Gated: every such row's largest |difference| is
    within SHARD_LOGIT_RTOL of the row's largest |logit| in ``one``.
    Returns the rows compared, the largest relative difference, and the
    share of rows whose top-1 - top-2 gap in ``one`` is no larger than the
    row's difference (a greedy token the difference can flip)."""
    for engine in (one, two):
        engine.reset()
        for r in reqs:
            engine.submit(r)
    rel, diffs, gaps, flippable = [], [], [], 0
    while one.model_ticks < ticks:
        if not (one.step() and two.step()):
            break
        if one.model_ticks != two.model_ticks:
            fail(f"{label}: one device and the shards ran {one.model_ticks} and "
                 f"{two.model_ticks} model ticks")
        live = [{st.req.id: (s, st.generated) for s, st in enumerate(e._slots) if st is not None}
                for e in (one, two)]
        held = [e.held_logits().float().cpu() for e in (one, two)]
        for rid, (s, gen) in live[0].items():
            if rid not in live[1] or live[1][rid][1] != gen:
                continue
            a, b = held[0][s], held[1][live[1][rid][0]]
            diff, top = float((a - b).abs().max()), torch.topk(a, 2).values
            rel.append(diff / float(a.abs().max()))
            diffs.append(diff)
            gaps.append(float(top[0] - top[1]))
            flippable += gaps[-1] <= diff
    res = {"ticks": one.model_ticks, "rows": len(rel), "max_rel_diff": max(rel, default=None),
           "max_abs_diff": max(diffs, default=None),
           "median_abs_diff": float(np.median(diffs)) if diffs else None,
           "median_top2_gap": float(np.median(gaps)) if gaps else None,
           "flippable_share": flippable / len(rel) if rel else None}
    if not rel or max(rel) > SHARD_LOGIT_RTOL:
        fail(f"{label}: the shards' held logits part from one device's by more than "
             f"{SHARD_LOGIT_RTOL} of the row's largest |logit|: {res}")
    return res


def sharded_small(label: str, device) -> dict:
    """At f32 on 2 layers (full widths), SHARD_SMALL's workload at once:
    the two-shard engine's tokens equal the one-device engine's and the
    static oracle's on the card; then a ``device_loss`` injection in a
    rerun is logged, its device's range quarantined and its slots retired,
    and every request still completes with the oracle's tokens.  Gated."""
    small = make_model(dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32"))
    master = small.init(SEED, DEV)
    n, lo, hi, new = SHARD_SMALL
    reqs = seeded_requests(small.cfg.vocab, n, lo, hi, new, 0, SEED)
    kw = {"num_slots": SLOTS, "max_seq": required_max_seq(reqs), "chunk": CHUNK,
          "block_size": BLOCK}
    one = ContinuousEngine(small, master, device=DEV, **kw)
    one_toks = {c.request_id: c.tokens for c in one.run(reqs)}
    oracle = static_reference(small, one.params, reqs, ServeConfig())
    del one
    two = ContinuousEngine(small, master, devices=SHARDS, device=device, **kw)
    two_toks = {c.request_id: c.tokens for c in two.run(reqs)}
    same_one = sum(np.array_equal(t, one_toks[i]) for i, t in two_toks.items())
    same_oracle = sum(np.array_equal(t, oracle[i]) for i, t in two_toks.items())
    two.reset()
    inj = FaultInjector(two, seed=3)
    for r in reqs:
        two.submit(r)
    lost = None
    while two.step():
        if lost is None:
            rec = inj.inject("device_loss")
            lost = None if rec is None else rec.device
    dead = sorted(two.pool._lost_devices)
    survivors = {c.request_id: c.tokens for c in two.completions}
    same_loss = sum(np.array_equal(t, oracle[i]) for i, t in survivors.items())
    m = two.metrics()
    lo_b = (lost or 0) * two.pool.blocks_per_device
    res = {"one_device_identical": f"{same_one}/{n}", "oracle_identical": f"{same_oracle}/{n}",
           "device_lost": lost, "lost_devices": dead,
           "device_lost_logged": any(e[0] == "device_lost" for e in two.event_log),
           "range_quarantined": set(range(lo_b, lo_b + two.pool.blocks_per_device))
           <= two.pool.quarantined,
           "after_loss_oracle_identical": f"{same_loss}/{n}",
           "after_loss_retries": m["retries"], "after_loss_device_admits": m["device_admits"]}
    print(f"[{label}-2l-f32] {json.dumps(res)}")
    if same_one != n or same_oracle != n:
        fail(f"{label}: at 2 layers f32 the two-shard tokens part from one device's or the "
             f"static oracle's: {res}")
    if (lost is None or dead != [lost] or not res["device_lost_logged"]
            or not res["range_quarantined"] or len(survivors) != n or same_loss != n
            or any(two.pool.device_of(s) == lost for s in two.pool._free_slots)):
        fail(f"{label}: device loss not contained: {res}")
    return res


# the MoE case: llama4-scout at MOE_LAYERS layers (phase 18's cut), f32, over
# SHARDS slots, one a shard, so that the shards place every request in the
# slot one device gives it and each tick's GShard group holds the same tokens
# in the same order; SHARD_MOE = (requests, shortest and longest prompt, new).
# The shards' projections see half the rows of one device's and round
# otherwise on the card, even at f32, and one flipped routing choice moves
# other tokens' capacity slots, so a run is held to one device's tick by tick
# up to its first routing or token difference: every held logit and router
# logit before it, and the router logits of the layer where routing first
# differs, within MOE_RTOL of the row's (the layer's) largest |value|
SHARD_MOE = (6, 16, 96, 8)
MOE_RTOL = 2.0 ** -5


class routes_recorded:
    """``models.moe.route`` wrapped for a block: each call appends (the
    calling shard of a lockstep tick, or None; then, each over the group's
    tokens in slot order, the router logits, the top-k choices and which
    of them are kept), copied to the CPU, to the list ``with`` gives."""

    def __enter__(self) -> list:
        self.saved, calls = moe_mod.route, []

        def recorded(*args, **kw):
            r = self.saved(*args, **kw)
            ex = getattr(moe_mod._tls, "exchange", None)
            calls.append((None if ex is None else ex[1],
                          *(r[k].flatten(0, 1).cpu() for k in ("logits", "idx", "keep"))))
            return r

        moe_mod.route = recorded
        return calls

    def __exit__(self, *exc):
        moe_mod.route = self.saved


def _ticked_lanes(engine) -> list:
    """A list that gets, at each tick of ``engine``, its slots' lanes that
    held a token (slot -> a prefill chunk's, or 1 a decoding slot), as the
    tick hands them to ``pool.advance``; the other lanes route too, and
    reach a live token only through the capacity they take."""
    got, advance = [], engine.pool.advance

    def recorded(counts):
        got.append(dict(counts))
        return advance(counts)

    engine.pool.advance = recorded
    return got


def _tokens_so_far(engine) -> dict:
    """Request id -> its new tokens so far, live or done."""
    out = {c.request_id: list(c.new_tokens) for c in engine.completions}
    out.update({st.req.id: list(st.generated) for st in engine._slots if st is not None})
    return out


def moe_in_step(label: str, pairs: dict, reqs) -> dict:
    """For each read (name -> (a one-device engine, eager; lockstep shards;
    the read)), both engines from a reset through ``reqs``, tick by tick.
    Gated, each tick: the shards' slots hold one device's tokens in their
    lanes, and the shards route their group alike (bitwise); up to the
    read's first routing or token difference (its ``event``), the router
    logits of every token a lane holds and every held logits row of the
    tick's slots within MOE_RTOL of the layer's (the row's) largest |value|
    on one device; at a routing difference, that layer's router logits
    too.  At the end every request has one device's tokens when no event
    came.  Returns per read the event, the rows, router layers and ticks
    compared, the largest relative differences, the shards' launches and
    mean tick ms, one device's mean tick ms, both engines' tokens."""
    zero = {k: 0 for k in counters.launch_counts()}
    res, ticked, logs = {}, {}, {name: [] for name in pairs}
    for name, (one, two, _) in pairs.items():
        for engine in (one, two):
            engine.reset()
            for r in reqs:
                engine.submit(r)
        ticked[name] = (_ticked_lanes(one), _ticked_lanes(two))
        res[name] = {"event": None, "rows": 0, "router_layers": 0, "ticks": 0,
                     "max_held_rel_diff": 0.0, "max_router_rel_diff": 0.0,
                     "launches": dict(zero)}
    going = set(pairs)
    with routes_recorded() as calls:
        while going:
            for name in sorted(going):
                one, two, read = pairs[name]
                st = res[name]
                with swapped("FORCE_PAGED_READ", read):
                    n0 = len(calls)
                    held = one.held_logits().float().cpu()
                    if not one.step():
                        going.discard(name)
                        if two.step():
                            fail(f"{label}-moe: {name}: the shards outlast one device")
                        continue
                    logs[name].append((one.model_ticks, held, _tokens_so_far(one)))
                    mine, lanes = [r[1:] for r in calls[n0:]], ticked[name][0][-1]
                    n0, before = len(calls), counters.launch_counts()
                    two.step()
                st["launches"] = {k: st["launches"][k] + v - before[k]
                                  for k, v in counters.launch_counts().items()}
                if two.model_ticks != one.model_ticks or ticked[name][1][-1] != lanes:
                    fail(f"{label}-moe: {name}: the shards' tick {two.model_ticks} took "
                         f"{ticked[name][1][-1]}, one device's {one.model_ticks} {lanes}")
                shards = {}
                for d, *rec in calls[n0:]:
                    shards.setdefault(d, []).append(rec)
                if (set(shards) != set(range(SHARDS))
                        or any(len(v) != len(mine) or any(
                            not all(torch.equal(x, y) for x, y in zip(a, b))
                            for a, b in zip(v, shards[0])) for v in shards.values())):
                    fail(f"{label}-moe: {name}: the shards route the tick's group apart")
                if st["event"] is not None:
                    continue
                st["ticks"] += 1
                width = mine[0][0].shape[0] // one.num_slots if mine else 0
                valid = torch.tensor([j < lanes.get(s, 0) for s in range(one.num_slots)
                                      for j in range(width)], dtype=torch.bool)
                for layer, (a, b) in enumerate(zip(mine, shards[0])):
                    lo1, lo2 = a[0][valid], b[0][valid]
                    rel = float((lo1 - lo2).abs().max() / lo1.abs().max())
                    st["router_layers"] += 1
                    st["max_router_rel_diff"] = max(st["max_router_rel_diff"], rel)
                    moved = ((a[1][valid] != b[1][valid]) | (a[2][valid] != b[2][valid])).any(-1)
                    if moved.any():
                        st["event"] = {"kind": "routing", "tick": one.model_ticks,
                                       "layer": layer, "router_rel_diff": rel,
                                       "tokens_rerouted": int(moved.sum())}
                        break
                if st["event"] is not None:
                    continue
                held, other = one.held_logits().float().cpu(), two.held_logits().float().cpu()
                for s in lanes:
                    diff = float((held[s] - other[s]).abs().max())
                    st["rows"] += 1
                    st["max_held_rel_diff"] = max(st["max_held_rel_diff"],
                                                  diff / float(held[s].abs().max()))
                mine_toks, theirs = _tokens_so_far(one), _tokens_so_far(two)
                parted = sorted(i for i in mine_toks if mine_toks[i] != theirs.get(i))
                if parted:
                    st["event"] = {"kind": "token", "tick": one.model_ticks,
                                   "requests": parted}
    res["one_device_apart"] = reads_apart(logs)
    for name, (one, two, _) in pairs.items():
        st = res[name]
        want = {c.request_id: c.new_tokens for c in one.completions}
        got = {c.request_id: c.new_tokens for c in two.completions}
        if got.keys() != want.keys():
            fail(f"{label}-moe: {name}: the shards completed {sorted(got)}, one device "
                 f"{sorted(want)}")
        same = sum(np.array_equal(t, want[i]) for i, t in got.items())
        st.update({"one_device_identical": f"{same}/{len(want)}",
                   "one_device_new_token_share": common_prefix(got, want),
                   "tick_ms": float(np.mean([dt * 1e3 for *_, dt in two.tick_log])),
                   "one_device_tick_ms": float(np.mean([dt * 1e3 for *_, dt in one.tick_log])),
                   "sentinel_violations": [e.metrics()["sentinel_violations"]
                                           for e in (one, two)],
                   "tokens": (want, got)})
        if not st["rows"] and not st["router_layers"]:
            fail(f"{label}-moe: {name}: nothing compared before its first difference: {st}")
        if max(st["max_held_rel_diff"], st["max_router_rel_diff"]) > MOE_RTOL:
            fail(f"{label}-moe: {name}: the shards part from one device by more than "
                 f"{MOE_RTOL} before their first routing or token difference: "
                 f"{ {k: v for k, v in st.items() if k != 'tokens'} }")
        if st["event"] is None and same != len(want):
            fail(f"{label}-moe: {name}: the shards' tokens part from one device's with no "
                 f"routing or token difference in their ticks: {st['one_device_identical']}")
    return res


def reads_apart(logs: dict) -> dict:
    """One device's kernel-read and streamed-read engines, tick by tick
    (``moe_in_step``'s logs: each tick's number, the held logits before it,
    the tokens after it): the first tick at which their tokens part and, at
    it, each slot whose greedy pick from the held logits differs, with the
    two rows' largest difference relative to the row's largest |logit| and
    the row's top-2 gap.  ``near_tie``: no tick parted, or every such
    slot's rows within MOE_RTOL of each other (a greedy near-tie of logits
    the two reads computed alike, ROADMAP Expected difference 19); a
    parting with no such slot, or one past MOE_RTOL, is another cause."""
    for (t, held_k, tok_k), (_, held_s, tok_s) in zip(logs["kernel"], logs["streamed"]):
        if tok_k == tok_s:
            continue
        flips = []
        for s in range(held_k.shape[0]):
            if int(held_k[s].argmax()) != int(held_s[s].argmax()):
                top2 = held_k[s].topk(2).values
                flips.append({"slot": s, "top2_gap": float(top2[0] - top2[1]),
                              "held_rel_diff": float((held_k[s] - held_s[s]).abs().max()
                                                     / held_k[s].abs().max())})
        return {"tick": t, "flips": flips,
                "near_tie": bool(flips) and all(f["held_rel_diff"] <= MOE_RTOL for f in flips)}
    return {"tick": None, "flips": [], "near_tie": True}


def moe_pin(toks: dict, ref: dict) -> list[float]:
    """Each request's longest common prefix with ``ref`` as a share of its
    whole sequence (prompt and new tokens): the reference's MoE pin
    (``tests/test_torch_moe.py``) asks at least 0.5 of each and 0.7 on
    average."""
    return [common_prefix({i: toks[i]}, {i: ref[i]})[0] for i in ref]


def sharded_moe(label: str, device) -> dict:
    """A MoE model over two shards (lockstep ticks, one GShard group a tick
    across them) on the streamed and on the kernel read, each in step with
    one device on the same read (``moe_in_step``, gated); the shards tick
    in lockstep, eagerly (gated); the kernel read's whole sequences keep
    the reference's MoE pin against the static oracle (gated).  Reported:
    each read's first difference from one device, its share of one
    device's new tokens and its tick ms; the two reads' share of each
    other's new tokens on one device; the kernel read's share of the
    oracle's new tokens."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS, dtype="float32")
    model = make_model(cfg)
    master = model.init(SEED, DEV)
    n, lo, hi, new = SHARD_MOE
    reqs = seeded_requests(cfg.vocab, n, lo, hi, new, 1, SEED)
    kw = {"num_slots": SHARDS, "max_seq": required_max_seq(reqs), "chunk": CHUNK,
          "block_size": BLOCK}
    pairs = {}
    for name, read in (("streamed", "streamed"), ("kernel", None)):
        with swapped("FORCE_PAGED_READ", read):
            pairs[name] = (ContinuousEngine(model, master, device=DEV, **kw),
                           ContinuousEngine(model, master, devices=SHARDS, device=device, **kw),
                           read)
        pairs[name][0].shards[0]._graphs = None  # eager, so that its routing is recorded
        two = pairs[name][1]
        if not two.lockstep or any(sh._graphs is not None for sh in two.shards):
            fail(f"{label}-moe: the MoE shards do not tick in lockstep, eagerly")
        if two.read_path != name:
            fail(f"{label}-moe: the {name} shards read through {two.read_path}")
    reads = moe_in_step(label, pairs, reqs)
    kern = pairs["kernel"][1]
    oracle = static_reference(model, kern.params, reqs, ServeConfig())
    # the oracle's static decoders, kept on the model, hold the 4 layers' f32
    # weights (~42 GB) until a collection
    model.__dict__.pop("_static_decoders", None)
    kern_full = {c.request_id: c.tokens for c in kern.completions}
    del pairs, kern, master, model
    release()
    fracs = moe_pin(kern_full, oracle)
    launches = {k: reads["streamed"]["launches"][k] + reads["kernel"]["launches"][k]
                for k in reads["streamed"]["launches"]}
    prompts = {r.id: len(r.tokens) for r in reqs}
    res = {"arch": MOE_ARCH, "layers": MOE_LAYERS, "dtype": "float32", "slots": SHARDS,
           "rtol": MOE_RTOL,
           **{read: {k: v for k, v in reads[read].items() if k != "tokens"}
              for read in ("streamed", "kernel")},
           "one_device_kernel_vs_streamed_new_token_share": common_prefix(
               reads["kernel"]["tokens"][0], reads["streamed"]["tokens"][0]),
           "kernel_read_oracle_lcp": fracs, "one_device_reads_apart": reads["one_device_apart"],
           "kernel_read_oracle_new_token_share": common_prefix(
               reads["kernel"]["tokens"][1], {i: t[prompts[i]:] for i, t in oracle.items()}),
           "launches": launches}
    print(f"[{label}-moe] {json.dumps(res)}")
    if min(fracs) < 0.5 or float(np.mean(fracs)) < 0.7:
        fail(f"{label}-moe: the kernel read misses the reference's MoE pin against the "
             f"static oracle: {res}")
    if not reads["one_device_apart"]["near_tie"]:
        fail(f"{label}-moe: one device's kernel-read and streamed-read engines part other than "
             f"at a greedy near-tie within {MOE_RTOL}: {res['one_device_reads_apart']}")
    if not launches["gn_softmax"] or not reads["kernel"]["launches"]["gn_paged_attention"]:
        fail(f"{label}-moe: the shards' ticks launched no GN kernel: {res}")
    return res


def phase_sharded(served: dict) -> dict:
    """Phase 25 (``[sharded]``): phase 4's workload and weights through a
    two-shard engine (see the module docstring)."""
    label = "sharded"
    device, placement = shard_placement()
    model = make_model(get_config(ARCH))
    reqs = seeded_requests(model.cfg.vocab, REQUESTS, MIN_PROMPT, MAX_PROMPT, NEW, 1, SEED)
    master = model.init(SEED, DEV)
    engine = ContinuousEngine(model, master, num_slots=SLOTS,
                              max_seq=required_max_seq(reqs), chunk=CHUNK, block_size=BLOCK,
                              devices=SHARDS, device=device)
    first, launches, seconds = first_run(label, engine, reqs)
    m = engine.metrics()
    keys = len(m["fused_buckets"]) + len(m["decode_buckets"])
    if m["graph_captures"] != [keys] * SHARDS:
        fail(f"{label}: captures {m['graph_captures']}, want {keys} a shard (one a key)")
    captures, steady_s, m = timed_replay(label, engine, reqs, first, launches)
    tick_ms = [dt * 1e3 for _, _, dt in engine.tick_log]
    ticks = m["model_ticks"]
    traced = min(LONG_WINDOW, ticks)
    start = (ticks - traced) // 2
    toks, base_s, _ = window_run(engine, reqs, start, traced)
    budget, dtoh_traces = audit.dtoh_budget(engine, traced), []
    for _ in range(AUDIT_TRACES):  # a trace of replays can lose records: take it again
        toks_traced, traced_s, prof = window_run(engine, reqs, start, traced, trace=True)
        copies = audit.memcpy_records(prof)
        dtoh_traces.append(copies.get("DtoH", 0))
        if dtoh_traces[-1] == budget:
            break
    if any(not np.array_equal(first[i], t[i]) for t in (toks, toks_traced) for i in first):
        fail(f"{label}: a windowed rerun gave other tokens")
    busy_s = sum(_device_us(prof).values()) / 1e6
    if copies.get("DtoH", 0) != budget:
        fail(f"{label}: {copies.get('DtoH', 0)} device-to-host copies in {traced} replayed "
             f"ticks, want one a shard a tick ({budget}): {copies}")
    # every shard's replay of every captured graph, bitwise against its eager tick
    engine.reset()
    for req in reqs:
        engine.submit(req)
    with checked_graphs(label, engine, lambda t: False) as checks:
        while engine.step():
            pass
    toks = {c.request_id: c.new_tokens for c in engine.completions}
    if toks.keys() != first.keys() or any(not np.array_equal(first[i], toks[i]) for i in first):
        fail(f"{label}: the checked rerun gave other tokens")
    captured = {(*key, d) for d, sh in enumerate(engine.shards) for key in sh._graphs._graphs}
    if set(checks.keys) != captured:
        fail(f"{label}: graphs checked against their eager tick {sorted(checks.keys)} != "
             f"captured {sorted(captured)}")
    one = ContinuousEngine(model, master, num_slots=SLOTS, max_seq=engine.max_seq, chunk=CHUNK,
                           block_size=BLOCK, device=DEV)
    one.shards[0]._graphs = None  # eager: held to its graphs in phase 4
    held = held_agreement(label, one, engine, reqs, SHARD_PROBE_TICKS)
    del one
    prefix = common_prefix(first, served["new_tokens"])
    res = {"card": str(roofline.card()), "placement": placement,
           "devices": [str(d) for d in engine.shard_devices],
           "requests": len(first), "generated_tokens": m["generated_tokens"],
           "first_run_seconds": seconds, "launches": launches,
           "captures": {"fused": captures[0], "decode": captures[1]},
           "graph_captures": m["graph_captures"], "capture_seconds": m["capture_seconds"],
           "steady_seconds": steady_s, "steady_tokens_per_s": m["generated_tokens"] / steady_s,
           "steady_mean_tick_ms": float(np.mean(tick_ms)), "model_ticks": ticks,
           "shard_balance": m["shard_balance"], "device_admits": m["device_admits"],
           "profiled_ticks": traced, "device_busy_seconds": busy_s,
           "device_busy_share": busy_s / base_s, "memcpy_records": copies,
           "dtoh_budget": budget, "dtoh_traces": dtoh_traces,
           "one_device_identical": f"{sum(p == 1.0 for p in prefix)}/{len(prefix)}",
           "one_device_agreement": float(np.mean(prefix)),
           "one_device_tokens_per_s": served["steady_tokens_per_s"],
           "held_logits_vs_one_device": held, "eager_checked": len(checks.keys),
           "eager_mean_tick_ms": float(np.mean(checks.eager_ms)),
           "eager_check_seconds": checks.seconds}
    print(f"[{label}] {json.dumps(res)}")
    del engine
    release()
    small = sharded_small(label, device)
    moe = sharded_moe(label, device)
    return {**res, "small": small, "moe": {k: v for k, v in moe.items() if k != "launches"},
            "launches": {k: res["launches"][k] + moe["launches"][k] for k in res["launches"]}}


# ----------------------------------------------------------------- phase 26 --
# phase 11's training on a (data, model) mesh: SHARD_TRAIN_STEPS steps from
# phase 11's weights, held to phase 11's losses within SHARD_TRAIN_RTOL (the
# tolerance test_torch_train.py holds the port's step to JAX's); the
# checkpoint round trip on the reduced config (at full widths even 2 layers'
# f32 masters and moments are 7.4 GB: 28 s to save and restore on a slow host)
SHARD_TRAIN_STEPS, SHARD_TRAIN_RTOL = 3, 1e-5


def mesh_steps(shape: tuple, model, steps: int, seed: int = SEED) -> dict:
    """``steps`` of phase 11's step (optimizer, batch, microbatches) over a
    ``shape`` (data, model) mesh of this process group, from ``model.init
    (seed)``: losses, step ms, launches, and the final (params, state)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import distribute_params, use_sharding

    from repro_torch.launch.dryrun import local_bytes

    opt = step_opt()
    batch = train_batch(model.cfg.vocab)
    step = make_train_step(model, opt, TRAIN_MB)
    losses, ms = [], []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with use_sharding(make_test_mesh(shape)):
        params = distribute_params(model, model.init(seed, DEV))
        state = init_opt_state(opt, params)
        torch.cuda.synchronize()
        counters.reset()
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    # this rank's parameters, AdamW state and batch (the step's arguments),
    # and the peak of what the run allocated on top of what was there before
    args = {"params": local_bytes(params), "opt_state": local_bytes(state),
            "inputs": sum(np.asarray(v).nbytes for v in batch.values())}
    return {"losses": losses, "step_ms": ms, "launches": counters.launch_counts(),
            "plain": counters.plain_cuda_calls(), "tree": (params, state), "step": step,
            "batch": batch, "argument_parts": args,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}


def mesh_rank(rank: int, world: int, shape: tuple, want: list) -> dict:
    """One rank of phase 26's multi-card meshes (rank 0's result returned)."""
    run = mesh_steps(shape, make_model(get_config(ARCH)), SHARD_TRAIN_STEPS)
    return {"mesh": list(shape), "losses": run["losses"], "step_ms": run["step_ms"],
            "max_rel_gap_to_one_device": max(abs(a - b) / abs(b)
                                             for a, b in zip(run["losses"], want))}


def phase_sharded_train(train: dict, card: str) -> dict:
    """Phase 26 (``[sharded-train]``): phase 11's full-width training under
    an NCCL group of one rank on a (1, 1) mesh (parameters, moments and
    gradients DTensors; every kernel through ``local_map`` on local
    shards), then the reduced config's checkpoint saved, ``restore_sharded``
    and one more step; with two cards or more, (1, n) and (n, 1) meshes over them
    (one NCCL rank a card).  Gated: the launches exact (phase 11's kernels,
    no plain version), each loss within SHARD_TRAIN_RTOL of phase 11's (and
    of the unsharded 2-layer steps), the multi-card losses finite and
    falling."""
    import torch.distributed as dist

    from repro_torch.launch import _host_devices

    label = "sharded-train"
    cfg = get_config(ARCH)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        _host_devices.join_group(0, 1, str(root / "store"), DEV)
        try:
            run = mesh_steps((1, 1), make_model(cfg), SHARD_TRAIN_STEPS)
            del run["tree"]
            want = train_want(cfg.n_layers, TRAIN_MB * SHARD_TRAIN_STEPS)
            gaps = [abs(a - b) / abs(b) for a, b in zip(run["losses"], train["losses"])]
            res = {"card": card, "arch": ARCH, "mesh": [1, 1], "losses": run["losses"],
                   "phase11_losses": train["losses"][:SHARD_TRAIN_STEPS],
                   "max_rel_gap": max(gaps), "first_step_ms": run["step_ms"][0],
                   "step_ms": run["step_ms"][1:], "phase11_step_ms": train["step_ms"],
                   "launches": run["launches"], "argument_parts": run["argument_parts"],
                   "peak_bytes": run["peak_bytes"]}
            if run["launches"] != want or any(run["plain"].values()):
                fail(f"{label}: launches {run['launches']} != {want}, plain {run['plain']}")
            if max(gaps) > SHARD_TRAIN_RTOL:
                fail(f"{label}: the (1, 1) mesh's losses part from phase 11's by more than "
                     f"{SHARD_TRAIN_RTOL}: {res}")
            res["restore"] = mesh_restore(label, root)
        finally:
            dist.destroy_process_group()
        n = torch.cuda.device_count()
        for shape in (((1, n), (n, 1)) if n >= 2 else ()):
            got = _host_devices.run_ranks(n, mesh_rank, (shape, train["losses"]), "cuda")
            res[f"mesh_{shape[0]}x{shape[1]}"] = got
            if (not all(math.isfinite(x) for x in got["losses"])
                    or any(b >= a for a, b in zip(got["losses"], got["losses"][1:]))):
                fail(f"{label}: the {shape} mesh's losses are not finite and falling: {got}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[{label}] {json.dumps(res)}")
    release()
    return res


def mesh_restore(label: str, root: Path) -> dict:
    """The reduced config (CPU tests' size): one step on the (1, 1) mesh,
    the checkpoint saved (rank 0 writes the logical arrays), restored with
    ``restore_sharded`` onto fresh DTensors, and a second step, whose loss
    must equal the unsharded second step's within SHARD_TRAIN_RTOL."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import use_sharding

    small = make_model(reduce_config(get_config(ARCH)))
    t0 = time.perf_counter()
    run = mesh_steps((1, 1), small, 1)
    store.save(root / "ckpt", 1, run["tree"])
    saved_s = time.perf_counter() - t0
    del run
    fresh = mesh_steps((1, 1), small, 0)  # the mesh's DTensors to restore onto
    t0 = time.perf_counter()
    with use_sharding(make_test_mesh((1, 1))):
        (params, state), man = store.restore_sharded(root / "ckpt", 1, fresh["tree"])
        restored_s = time.perf_counter() - t0
        _, _, m = fresh["step"](params, state, fresh["batch"])
    restored = float(m["loss"])
    del fresh, params, state
    opt = step_opt()
    step = make_train_step(small, opt, TRAIN_MB)
    params = small.init(SEED, DEV)
    state = init_opt_state(opt, params)
    batch = train_batch(small.cfg.vocab)
    losses = []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    del params, state
    res = {"config": small.cfg.name, "step": man["step"], "restored_step_loss": restored,
           "unsharded_losses": losses, "save_seconds": saved_s, "restore_seconds": restored_s,
           "rel_gap": abs(restored - losses[1]) / abs(losses[1])}
    if res["rel_gap"] > SHARD_TRAIN_RTOL or man["step"] != 1:
        fail(f"{label}: the restored step parts from the unsharded second step: {res}")
    return res


# ----------------------------------------------------------------- phase 27 --
# the multi-pod dry run (launch/dryrun.py) on the card's torch over fake
# tensors of device cuda: (arch, shape, multi_pod) cells, each cut to
# DRYRUN_DEPTH layers (the script's time limit; a hybrid keeps one shared
# block's group); phase 26's own step against its measured peak within
# DRYRUN_MEM_RTOL
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False), ("internlm2-1.8b", "prefill_32k", False),
                ("internlm2-1.8b", "decode_32k", False), ("internlm2-1.8b", "train_4k", True),
                ("llama4-scout-17b-a16e", "train_4k", False), ("zamba2-7b", "long_500k", False),
                ("minicpm3-4b", "decode_32k", False))
DRYRUN_DEPTH, DRYRUN_MEM_RTOL = 1, 0.15


def dryrun_cfg(arch: str):
    """``arch`` cut to DRYRUN_DEPTH layers (a hybrid to one group of
    ``attn_every``)."""
    cfg = get_config(arch)
    layers = cfg.attn_every if cfg.family == "hybrid" else DRYRUN_DEPTH
    return dataclasses.replace(cfg, n_layers=layers)


def phase_dryrun(sharded_train: dict, card: str) -> dict:
    """Phase 27 (``[dryrun]``): (a) ``launch.dryrun``'s cells of
    DRYRUN_CELLS over fake tensors of device cuda on the production meshes:
    every cell ok, and no kernel launched and no plain version run on the
    card (the counters do not move; gated); per cell its seconds, memory,
    collective bytes by kind and roofline terms; (b) the dry run of phase
    26's own step (its config, batch, optimizer and microbatches on a
    (1, 1) mesh): its argument bytes equal to phase 26's parameter, AdamW
    state and batch bytes exactly, no collective bytes, and argument +
    temp bytes within DRYRUN_MEM_RTOL of phase 26's measured peak (gated);
    the roofline's terms beside phase 26's step ms."""
    from repro_torch.configs.base import ALL_SHAPES, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.roofline.op_cost import collective_bytes

    label = "dryrun"
    shapes = {s.name: s for s in ALL_SHAPES}
    before = (counters.launch_counts(), counters.plain_cuda_calls())
    cells = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        for arch, shape, multi in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shapes[shape], multi, root, DEV, dryrun_cfg(arch))
            cells[f"{arch}__{shape}__{rec['mesh']}"] = {
                k: rec.get(k) for k in ("ok", "error", "lower_s", "call_s", "memory",
                                        "collective_bytes", "roofline")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    after = (counters.launch_counts(), counters.plain_cuda_calls())
    cfg = get_config(ARCH)
    tokens = np.asarray(train_batch(cfg.vocab)["tokens"])
    got = dryrun.record_call(
        cfg, ShapeConfig("phase26", TRAIN_SEQ, TRAIN_BATCH, "train"), 1,
        lambda: make_test_mesh((1, 1), device_type=torch.device(DEV).type), DEV, opt_cfg=step_opt(),
        microbatches=TRAIN_MB, batch={"tokens": (tokens.shape, getattr(torch, str(tokens.dtype)))})
    mem, want = got["memory"], sharded_train["argument_parts"]
    roof = roofline.analyze(got["records"], got["n_chips"], got["model_flops"])
    coll = collective_bytes(got["records"])
    total = mem["argument_bytes"] + mem["temp_bytes"]
    step = {"layers": cfg.n_layers, "memory": mem, "collective_bytes": coll,
            "phase26_argument_parts": want, "phase26_peak_bytes": sharded_train["peak_bytes"],
            "argument_plus_temp_rel_gap": total / sharded_train["peak_bytes"] - 1.0,
            "roofline": roof.to_dict(), "phase26_step_ms": sharded_train["step_ms"],
            "call_s": got["seconds"]}
    res = {"card": card, "depth": DRYRUN_DEPTH, "cells": cells, "phase26_step": step,
           "launches_moved": before != after}
    print(f"[{label}] {json.dumps(res)}")
    bad = [k for k, c in cells.items() if not c["ok"]]
    if bad:
        fail(f"{label}: cells failed on the card's torch: "
             f"{ {k: cells[k]['error'] for k in bad} }")
    if before != after:
        fail(f"{label}: the dry run moved the launch counters: {before} -> {after}")
    if (mem["argument_parts"] != want or mem["argument_bytes"] != sum(want.values())
            or coll["total"] or abs(step["argument_plus_temp_rel_gap"]) > DRYRUN_MEM_RTOL):
        fail(f"{label}: the dry run of phase 26's step parts from the real one: {step}")
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
    "gn_softmax": ("src/repro_torch/csrc/gn_softmax.cuh",
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
    phase("audit", phase_audit, served, int8)
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
    prefix = phase("prefix", phase_prefix)
    sla = phase("sla", phase_sla)
    mla = phase("mla", phase_mla, served)
    moe = phase("moe", phase_moe, kern)
    slab = phase("slab", phase_slab, served)
    snap = phase("snapshot", phase_snapshot, served)
    long_chunked = phase("long-chunked", phase_long_chunked)
    cross = phase("cross", phase_cross)
    ssm = phase("ssm", phase_ssm)
    sharded = phase("sharded", phase_sharded, served)
    sharded_train = phase("sharded-train", phase_sharded_train, train, card)
    phase("dryrun", phase_dryrun, sharded_train, card)
    by_path = {"continuous": served["launches"], "static": static["launches"],
               "int8": int8["launches"], "long_static": long_static["launches"],
               "long_continuous": long_cont["launches"], "reads": reads["launches"],
               "sampled": guard["launches"], "train": train["launches"],
               "table1": table1["launches"], "tables": tables["launches"],
               "prefix": prefix["launches"], "sla": sla["launches"], "mla": mla["launches"],
               "moe": moe["launches"], "slab": slab["launches"], "snapshot": snap["launches"],
               "long_chunked": long_chunked["launches"], "cross": cross["launches"],
               **ssm["launches"], "sharded": sharded["launches"],
               "sharded_train": sharded_train["launches"]}
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
