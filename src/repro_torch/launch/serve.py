"""Serving entry point of the port: static batches or continuous batching,
greedy or sampled (``--temperature``), GN datapath.

Builds the config, draws random weights from ``--seed`` with a
``torch.Generator`` on the device, and serves.  Runs on CUDA unless
``--device`` says otherwise.  Two modes, as the reference launcher:
  * static (default): ``--batches`` batches of ``--batch-size`` synthetic
    Zipf-chain prompts of ``--prompt-len`` tokens, each decoded
    ``--new-tokens`` tokens by ``generate`` (a prompt past 2048 tokens
    prefills through the GN flash-attention kernel); one line per batch with
    its shape, seconds, tok/s and the teacher-forced perplexity of the whole
    sequence, then the overall tok/s;
  * ``--continuous``: a seeded numpy workload through ``ContinuousEngine``
    (GN sentinels on unless ``--no-sentinels``), one line per request and
    the per-tick phases and times, the sentinels' counters, then at
    temperature 0 the greedy outputs held against ``static_reference`` on
    the same requests (printed as k/n token-identical; a sampled run skips
    the oracle, as the reference launcher does).  The two agree token for
    token on the CPU at float32.  At bfloat16 the paged read keeps its
    scores in f32 where the static path rounds them to bf16, as the
    reference's does; on a GPU the online paged read and the one-pass
    static softmax may also break a near-tied argmax differently.

Usage:
  python -m repro_torch.launch.serve --arch internlm2-1.8b --batches 2 --batch-size 8
  python -m repro_torch.launch.serve --arch internlm2-1.8b --batches 1 --batch-size 4 \
      --prompt-len 4096
  python -m repro_torch.launch.serve --arch internlm2-1.8b --continuous [--temperature 0.7]
  python -m repro_torch.launch.serve --smoke --device cpu [--continuous]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.kernels import counters
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import (
    ContinuousEngine,
    ServeConfig,
    generate,
    perplexity,
    static_reference,
)
from repro_torch.serve.workload import required_max_seq, seeded_requests


def set_matmul_precision() -> None:
    """f32 matmuls in full f32 and bf16 matmuls accumulated in f32, as the
    reference's XLA dots (PyTorch's own defaults for the first, not the
    second)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU tests)")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="activation dtype (default: the config's)")
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0, help="0: greedy")
    ap.add_argument("--batches", type=int, default=3, help="static: number of batches")
    ap.add_argument("--batch-size", type=int, default=4, help="static: prompts per batch")
    ap.add_argument("--prompt-len", type=int, default=32, help="static: prompt tokens")
    ap.add_argument("--continuous", action="store_true", help="continuous batching")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8, help="prefill chunk (fused-tick lanes)")
    ap.add_argument("--block-size", type=int, default=0, help="KV block size (0: = chunk)")
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--stagger", type=int, default=1, help="ticks between arrivals")
    ap.add_argument("--no-sentinels", action="store_true",
                    help="continuous: serve without the GN runtime sentinels")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_static(model, params, args, device) -> dict:
    cfg = model.cfg
    data = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len, global_batch=args.batch_size,
                      seed=11)
    scfg = ServeConfig(max_new_tokens=args.new_tokens, temperature=args.temperature,
                       seed=args.seed)
    prompts, outputs, ppls, seconds = [], [], [], []
    total_tok = 0
    before = counters.launch_counts()
    t_all = time.perf_counter()
    for i in range(args.batches):
        tokens = torch.as_tensor(batch_at(data, i)["tokens"]).to(device)
        _sync(device)
        t0 = time.perf_counter()
        out = generate(model, params, {"tokens": tokens}, scfg)
        _sync(device)
        dt = time.perf_counter() - t0
        new_tok = args.batch_size * args.new_tokens
        total_tok += new_tok
        ppl = perplexity(model, params, {"tokens": out})
        print(f"batch {i}: {tuple(out.shape)} in {dt:.2f}s ({new_tok / dt:.1f} tok/s)  "
              f"seq ppl {ppl:.3f}")
        prompts.append(tokens)
        outputs.append(out)
        ppls.append(ppl)
        seconds.append(dt)
    dt_all = time.perf_counter() - t_all
    launches = {k: v - before[k] for k, v in counters.launch_counts().items()}
    print(f"served {args.batches} batches, {total_tok / dt_all:.1f} tok/s overall "
          f"(softmax={cfg.softmax_impl}, norm={cfg.norm_impl})")
    return {"model": model, "params": params, "data": data, "prompts": prompts,
            "outputs": outputs, "perplexities": ppls, "batch_seconds": seconds,
            "seconds": dt_all, "generated_tokens": total_tok, "launches": launches}


def _serve_continuous(model, args, device) -> dict:
    cfg = model.cfg
    reqs = seeded_requests(cfg.vocab, args.requests, args.min_prompt, args.max_prompt,
                           args.new_tokens, args.stagger, args.seed)
    # the engine keeps only its prepared copy of the weights
    engine = ContinuousEngine(model, model.init(args.seed, device), num_slots=args.num_slots,
                              max_seq=required_max_seq(reqs),
                              cfg=ServeConfig(temperature=args.temperature, seed=args.seed),
                              chunk=args.chunk, block_size=args.block_size,
                              sentinels=not args.no_sentinels, device=device)
    before = counters.launch_counts()
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in counters.launch_counts().items()}
    m = engine.metrics()
    print(f"served {cfg.name} on {device}: {m['completed']} requests, "
          f"{m['generated_tokens']} tokens in {seconds:.3f}s "
          f"({m['generated_tokens'] / seconds:.1f} tok/s), {m['model_ticks']} model ticks "
          f"({m['fused_ticks']} fused), peak blocks {m['peak_blocks_in_use']}"
          f"/{engine.pool.num_blocks}, horizon buckets fused {m['fused_buckets']} decode "
          f"{m['decode_buckets']}, {m['fused_step_compilations'] + m['decode_compilations']} "
          f"graph captures ({m['capture_seconds']:.2f}s)")
    print(f"  sentinels {'on' if m['sentinels'] else 'off'}: {m['sentinel_checks']} checks, "
          f"{m['sentinel_violations']} violations, {m['quarantined_blocks']} quarantined, "
          f"{m['retries']} retries, {m['fallbacks']} fallbacks")
    for i in range(0, len(engine.tick_log), 8):
        row = "  ".join(f"P{p}D{d} {dt * 1e3:.1f}ms"
                        for p, d, dt in engine.tick_log[i:i + 8])
        print(f"  ticks {i:4d}+ {row}")
    for c in sorted(comps, key=lambda c: c.request_id):
        print(f"  req {c.request_id}: prompt {len(c.prompt_tokens)} +{len(c.new_tokens)} "
              f"[{c.finish_reason}] arrive@{c.arrival_step} admit@{c.admit_step} "
              f"first@{c.first_token_step} finish@{c.finish_step} "
              f"latency {c.latency_s * 1e3:.0f}ms")
    out = {"engine": engine, "requests": reqs, "completions": comps, "seconds": seconds,
           "launches": launches}
    if args.temperature > 0:  # sampled: the greedy oracle does not apply
        return out
    # the static oracle on the same requests and weights
    ref = static_reference(model, engine.params, reqs, ServeConfig())
    prefix = []
    for c in comps:
        want = ref[c.request_id][c.prompt_tokens.shape[0]:]
        n = min(len(want), len(c.new_tokens))
        diff = np.nonzero(want[:n] != c.new_tokens[:n])[0]
        prefix.append(int(diff[0]) if diff.size else n)
    same = sum(np.array_equal(c.tokens, ref[c.request_id]) for c in comps)
    print(f"greedy outputs token-identical to static path: {same}/{len(comps)} "
          f"(mean common prefix {np.mean(prefix):.2f} of {args.new_tokens} new tokens)")
    return {**out, "static_identical": same, "common_prefix": prefix}


def main(argv=None) -> dict:
    """Serve one workload and return what a caller needs to check it: the
    kernel launches of the serving run itself (the continuous mode's static
    oracle excluded), its wall seconds and, per mode, the outputs (static:
    model, prepared params, prompts, outputs, perplexities; continuous: the
    engine, which a caller may ``reset`` and rerun, requests, completions,
    and at temperature 0 the oracle's identity count and common prefixes)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    set_matmul_precision()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = make_model(cfg)
    if args.continuous:
        return _serve_continuous(model, args, device)
    return _serve_static(model, model.prepare(model.init(args.seed, device), device), args,
                         device)


if __name__ == "__main__":
    main()
