"""End to end: train an LM with the GN non-GEMM ops, then score it (port of
``examples/train_lm.py``).

Trains a decoder-only LM on the deterministic synthetic Zipf-Markov corpus,
with GN-Softmax and GN-LayerNorm at every attention and norm site (the
kernels on the card), then reports held-out perplexity (the paper's
score-oriented metric) against the exact-ops twin: Table I's structure.

Defaults are small (~3M parameters, 200 steps); ``--full`` selects a ~100M
parameter config for the card.  Runs on CUDA unless ``--device`` says
otherwise.

Usage:
  python -m repro_torch.examples.train_lm [--steps 200] [--full] [--device cpu]
  python -m repro_torch.examples.train_lm --compare   # GN against the exact twin
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, batch_at, optimal_perplexity
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import perplexity
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_leaves


def lm_config(full: bool, softmax_impl: str, norm_impl: str) -> ModelConfig:
    if full:  # ~100M parameters (gpt-neo-small-ish)
        return ModelConfig(name="lm-100m", family="dense", n_layers=12, d_model=768,
                           n_heads=12, n_kv_heads=12, d_ff=3072, vocab=50304,
                           softmax_impl=softmax_impl, norm_impl=norm_impl, remat="none")
    return ModelConfig(name="lm-3m", family="dense", n_layers=4, d_model=128, n_heads=4,
                       n_kv_heads=4, d_ff=512, vocab=512, softmax_impl=softmax_impl,
                       norm_impl=norm_impl, remat="none", dtype="float32")


def train(cfg: ModelConfig, steps: int, seq: int, batch: int, device, seed: int = 0,
          params: Optional[dict] = None, batches: Optional[Callable] = None,
          log=print) -> tuple[float, list[float]]:
    """Train ``steps`` steps; returns (held-out perplexity, the losses).
    ``params`` (f32 masters) replaces the seeded init and ``batches(step)``
    the corpus, so a test can feed both packages the same weights and
    tokens."""
    model = make_model(cfg)
    params = model.init(seed, device) if params is None else params
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = make_train_step(model, opt_cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=7)
    batches = batches or (lambda step: batch_at(data, step))
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"[{cfg.name}] {n_params / 1e6:.1f}M params, softmax={cfg.softmax_impl}, "
        f"norm={cfg.norm_impl}, {device}")
    losses = []
    t0 = time.time()
    for step in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, batches(step))
        losses.append(float(metrics["loss"]))
        if step % max(1, steps // 10) == 0 or step == steps - 1:
            log(f"  step {step:4d}  loss {losses[-1]:.4f}  ({time.time() - t0:.1f}s)")
    # held-out eval: a step past the training range
    ppl = perplexity(model, model.prepare(params, device), batch_at(data, 10_000))
    log(f"  held-out perplexity: {ppl:.3f}  (corpus optimum ~{optimal_perplexity(data):.3f})")
    return ppl, losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--compare", action="store_true",
                    help="also train an exact-ops twin and compare perplexity")
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ppl_gn, _ = train(lm_config(args.full, "gn", "gn_ln"), args.steps, args.seq, args.batch,
                      device)
    out = {"gn": ppl_gn}
    if args.compare:
        ppl_exact, _ = train(lm_config(args.full, "exact", "exact_ln"), args.steps, args.seq,
                             args.batch, device)
        delta = 100.0 * (ppl_gn - ppl_exact) / ppl_exact
        print(f"\nGN vs exact perplexity: {ppl_gn:.3f} vs {ppl_exact:.3f} ({delta:+.2f}%)  "
              "[paper reports -0.09% on GPT-Neo/WikiText]")
        out["exact"] = ppl_exact
    return out


if __name__ == "__main__":
    main()
