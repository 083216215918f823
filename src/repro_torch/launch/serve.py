"""Serving entry point of the port: greedy continuous batching, GN datapath.

Builds the config, draws random weights from ``--seed`` with a
``torch.Generator`` on the device, serves a seeded numpy workload through
``ContinuousEngine`` and prints one line per request and the per-tick
phases and times.  Runs on CUDA unless ``--device`` says otherwise.

Usage:
  python -m repro_torch.launch.serve --arch internlm2-1.8b --continuous
  python -m repro_torch.launch.serve --smoke --continuous --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (the only serving mode ported)")
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--seed", type=int, default=0, help="weights and workload seed")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8, help="prefill chunk (fused-tick lanes)")
    ap.add_argument("--block-size", type=int, default=0, help="KV block size (0: = chunk)")
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--stagger", type=int, default=1, help="ticks between arrivals")
    return ap


def main(argv=None) -> dict:
    """Serve one workload; returns the engine, the requests, the completions
    and the wall seconds of the run (the caller may ``reset`` and rerun)."""
    args = build_parser().parse_args(argv)
    if not args.continuous:
        raise SystemExit("static serving is not ported; pass --continuous")
    device = resolve_device(args.device)
    set_matmul_precision()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    model = make_model(cfg)
    params = model.init(args.seed, device)
    reqs = seeded_requests(cfg.vocab, args.requests, args.min_prompt, args.max_prompt,
                           args.new_tokens, args.stagger, args.seed)
    engine = ContinuousEngine(model, params, num_slots=args.num_slots,
                              max_seq=required_max_seq(reqs),
                              chunk=args.chunk, block_size=args.block_size, device=device)
    del params  # the engine holds its prepared copy
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    seconds = time.perf_counter() - t0
    m = engine.metrics()
    print(f"served {cfg.name} on {device}: {m['completed']} requests, "
          f"{m['generated_tokens']} tokens in {seconds:.3f}s "
          f"({m['generated_tokens'] / seconds:.1f} tok/s), {m['model_ticks']} model ticks "
          f"({m['fused_ticks']} fused), peak blocks {m['peak_blocks_in_use']}"
          f"/{engine.pool.num_blocks}")
    for i in range(0, len(engine.tick_log), 8):
        row = "  ".join(f"P{p}D{d} {dt * 1e3:.1f}ms"
                        for p, d, dt in engine.tick_log[i:i + 8])
        print(f"  ticks {i:4d}+ {row}")
    for c in sorted(comps, key=lambda c: c.request_id):
        print(f"  req {c.request_id}: prompt {len(c.prompt_tokens)} +{len(c.new_tokens)} "
              f"[{c.finish_reason}] arrive@{c.arrival_step} admit@{c.admit_step} "
              f"first@{c.first_token_step} finish@{c.finish_step} "
              f"latency {c.latency_s * 1e3:.0f}ms")
    return {"engine": engine, "requests": reqs, "completions": comps, "seconds": seconds}


if __name__ == "__main__":
    main()
