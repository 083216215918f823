"""Batched serving with the GN non-GEMM ops, the paper's deployment scenario
(port of ``examples/serve_batched.py``).

The paper targets edge *inference*: Softmax/LayerNorm units inside a serving
datapath.  This example runs the static serving path on a small model:
prefill a batch of prompts, decode new tokens through the slab cache (CUDA
graph replays on the card), and score the prompts, comparing the GN
softmax against an unnormalized baseline (Softermax) and the exact one:
score-oriented serving (log-prob scoring, perplexity) is where guaranteed
normalization matters.  The weights are drawn once and shared by every
softmax (they do not depend on it).  Runs on CUDA unless ``--device`` says
otherwise.

Usage:
  python -m repro_torch.examples.serve_batched [--arch internlm2-1.8b] [--device cpu]
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
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ServeConfig, generate, perplexity

IMPLS = ("exact", "gn", "softermax")


def prompts_for(cfg, batch: int, prompt_len: int) -> dict:
    """The synthetic prompts, with zero frames or patches for the
    encoder-decoder and vision families."""
    data = DataConfig(vocab=cfg.vocab, seq_len=prompt_len, global_batch=batch, seed=3)
    prompts = dict(batch_at(data, 0))
    if cfg.family == "encdec":
        prompts["frames"] = np.zeros((batch, cfg.encoder_seq, cfg.d_model), np.float32)
    if cfg.family == "vlm":
        prompts["patches"] = np.zeros((batch, cfg.num_patches, cfg.d_model), np.float32)
    return prompts


def serve(base, master, prompts: dict, new_tokens: int, device,
          impls=IMPLS) -> dict[str, tuple[np.ndarray, float, float]]:
    """softmax name -> (generated tokens, prompt perplexity, seconds) over
    the same master weights."""
    out = {}
    for impl in impls:
        model = make_model(dataclasses.replace(base, softmax_impl=impl))
        params = model.prepare(master, device)
        t0 = time.perf_counter()
        with torch.no_grad():
            toks = generate(model, params, prompts, ServeConfig(max_new_tokens=new_tokens))
            toks = toks.cpu().numpy()
            ppl = perplexity(model, params, prompts)
        out[impl] = (toks, ppl, time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = reduce_config(get_config(args.arch))
    master = make_model(base).init(0, device)
    results = serve(base, master, prompts_for(base, args.batch, args.prompt_len),
                    args.new_tokens, device)
    for impl, (toks, ppl, dt) in results.items():
        print(f"[{impl:<9}] generated {toks.shape} in {dt:.2f}s "
              f"(prefill+{args.new_tokens} steps)  prompt ppl {ppl:.4f}")

    exact_out, exact_ppl, _ = results["exact"]
    print("\n== score-oriented serving: deviation from the exact datapath ==")
    for impl in IMPLS[1:]:
        toks, ppl, _ = results[impl]
        match = float((toks == exact_out).mean())
        print(f"  {impl:<9} token match {match * 100:5.1f}%   "
              f"ppl drift {100.0 * (ppl - exact_ppl) / exact_ppl:+.3f}%")
    print("\n(rank-oriented greedy argmax tolerates approximation; the ppl drift,")
    print(" the score-oriented metric, is where unnormalized baselines degrade.)")
    return {impl: {"ppl": ppl, "seconds": dt} for impl, (_, ppl, dt) in results.items()}


if __name__ == "__main__":
    main()
