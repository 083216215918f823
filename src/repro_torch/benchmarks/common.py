"""Shared plumbing of the port's accuracy benchmarks: train once, evaluate
many (port of ``benchmarks/common.py``'s ``tiny_cfg``, ``train_tiny``,
``eval_metrics`` and ``with_impls``).

The paper evaluates by injecting its approximation units into an FP32 model
at inference ("FP32 + Ours").  Here, as in the reference: a reduced GPT-Neo
backbone (the paper's perplexity backbone) trained on the synthetic
Zipf-Markov corpus with exact non-GEMM ops, checkpointed, then evaluated
with the same weights under each softmax/norm implementation.  Checkpoints
and results go under ``runs/table1/`` (git-ignored) unless a directory is
given.  Training and evaluation run on CUDA unless ``device`` says
otherwise; the corpus is the port's numpy ``batch_at``, so its batches are
not the reference's ``jax.random`` ones.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at, optimal_perplexity
from repro_torch.models.transformer import make_model
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

RUNS = Path(__file__).resolve().parents[3] / "runs" / "table1"

TINY_DATA = DataConfig(vocab=512, seq_len=64, global_batch=16, branching=8, zipf_a=1.5)


def tiny_cfg(**over):
    """Reduced gpt-neo-1.3b (d_model 128, 4 layers, vocab 512) with FP32
    exact non-GEMM ops, the baseline's training config."""
    cfg = reduce_config(get_config("gpt-neo-1.3b"), d_model=128, n_layers=4, n_heads=4,
                        n_kv_heads=4, d_ff=512, vocab=TINY_DATA.vocab)
    return dataclasses.replace(cfg, softmax_impl="exact", norm_impl="exact_ln",
                               dtype="float32", **over)


def train_tiny(steps: int = 300, tag: str = "tiny_lm", device=None, root: Path | None = None,
               **cfg_over):
    """Train (or load the cached checkpoint of) the tiny backbone: (cfg,
    model, f32 params, wall seconds of the training, 0 when cached)."""
    dev = resolve_device(device)
    cfg = tiny_cfg(**cfg_over)
    model = make_model(cfg)
    ckdir = (root or RUNS) / tag
    params = model.init(0, dev)
    if store.latest_step(ckdir) == steps:
        (params,), _ = store.restore(ckdir, steps, (params,))
        return cfg, model, params, 0.0
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps, weight_decay=0.01)
    opt_state = init_opt_state(opt_cfg, params)
    step_fn = make_train_step(model, opt_cfg)
    t0 = time.perf_counter()
    for step in range(steps):
        params, opt_state, m = step_fn(params, opt_state, batch_at(TINY_DATA, step))
        if step % 50 == 0 or step == steps - 1:
            print(f"  [train {tag}] step {step} loss {float(m['loss']):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    store.save(ckdir, steps, (params,))
    return cfg, model, params, seconds


def eval_metrics(cfg, params, n_batches: int = 4, seed0: int = 10_000) -> dict:
    """Held-out perplexity (score) and next-token top-1 accuracy (rank)."""
    model = make_model(cfg)
    dev = params["embed"]["tok"].device
    prepared = model.prepare(params, dev)
    nlls, accs = [], []
    with torch.no_grad():
        for i in range(n_batches):
            tokens = torch.as_tensor(batch_at(TINY_DATA, seed0 + i)["tokens"]).to(dev)
            logits = model.forward(prepared, {"tokens": tokens})[:, :-1].float()
            targets = tokens[:, 1:].long()
            logp = torch.log_softmax(logits, dim=-1)
            nlls.append(-logp.gather(-1, targets[..., None])[..., 0].cpu().numpy().ravel())
            accs.append((logits.argmax(dim=-1) == targets).cpu().numpy().ravel())
    nll, acc = np.concatenate(nlls), np.concatenate(accs)
    return {"perplexity": float(np.exp(nll.mean())), "top1_acc": float(acc.mean()),
            "optimal_perplexity": optimal_perplexity(TINY_DATA)}


def with_impls(cfg, softmax_impl: str, norm_impl: str):
    return dataclasses.replace(cfg, softmax_impl=softmax_impl, norm_impl=norm_impl)


def writeout(name: str, payload: dict, root: Path | None = None) -> dict:
    out = (root or RUNS) / "results"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(payload, indent=2, default=float))
    return payload
