"""Deterministic synthetic LM corpus: a Zipf-successor Markov chain (port of
``repro/data/synthetic.py``, numpy only).

Each token has exactly K possible successors, deterministic functions of
the current token; which one follows is drawn from a Zipf distribution, so
the optimal perplexity is ``exp(H(zipf))``, known in closed form.
``DataConfig``, ``zipf_probs``, ``optimal_perplexity`` and the successor
hash are the reference's.  The draws come from a numpy ``Generator`` seeded
by (seed, step), so they cannot match the reference's ``jax.random``
draws; a test that compares the packages feeds both the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 64
    global_batch: int = 8
    branching: int = 8          # K successors per token
    zipf_a: float = 1.5
    seed: int = 1234


def zipf_probs(cfg: DataConfig) -> np.ndarray:
    w = 1.0 / np.arange(1, cfg.branching + 1) ** cfg.zipf_a
    return (w / w.sum()).astype(np.float32)


def optimal_perplexity(cfg: DataConfig) -> float:
    p = zipf_probs(cfg)
    h = -(p * np.log(p)).sum()
    return float(np.exp(h))


def _successor(cfg: DataConfig, cur: np.ndarray, k: np.ndarray) -> np.ndarray:
    """k-th successor of token cur (deterministic hash)."""
    return (cur * 31 + k * 1000003 + 12345) % cfg.vocab


def batch_at(cfg: DataConfig, step: int) -> dict:
    """The deterministic batch of a step: {"tokens": (global_batch, seq_len)
    int32}, a first token uniform over the vocab, then the chain."""
    rng = np.random.default_rng((cfg.seed, step))
    x0 = rng.integers(0, cfg.vocab, size=cfg.global_batch)
    p = zipf_probs(cfg).astype(np.float64)
    ks = rng.choice(cfg.branching, size=(cfg.global_batch, cfg.seq_len - 1), p=p / p.sum())
    tokens = np.empty((cfg.global_batch, cfg.seq_len), np.int64)
    tokens[:, 0] = x0
    for t in range(1, cfg.seq_len):
        tokens[:, t] = _successor(cfg, tokens[:, t - 1], ks[:, t - 1])
    return {"tokens": tokens.astype(np.int32)}
