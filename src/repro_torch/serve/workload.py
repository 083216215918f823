"""Deterministic synthetic serving workloads, drawn with numpy from a seed
(port of ``repro/serve/workload.py``).

Prompt tokens come from the port's Zipf-chain corpus (``data/synthetic.py``),
whose draws cannot match the reference's ``jax.random`` ones; everything else
(lengths, budgets, arrivals, classes, the shared-prefix layout) is the
reference's, and ``sla_requests`` draws its arrivals, classes and lengths
from the same numpy stream as the reference's.  A test that compares the
packages builds its requests once and feeds both the same tokens.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.serve.scheduler import Request


def extras_for(cfg) -> dict:
    """The reference's modality stubs of a request: zero frames (encdec) or
    zero patches (VLM), f32 without a batch axis."""
    if cfg.family == "encdec":
        return {"frames": np.zeros((cfg.encoder_seq, cfg.d_model), np.float32)}
    if cfg.family == "vlm":
        return {"patches": np.zeros((cfg.num_patches, cfg.d_model), np.float32)}
    return {}


def _draw(vocab: int, length: int, seed: int) -> np.ndarray:
    data = DataConfig(vocab=vocab, seq_len=length, global_batch=1, seed=seed)
    return np.asarray(batch_at(data, 0)["tokens"][0], np.int32)


def seeded_requests(vocab: int, n_requests: int, min_len: int, max_len: int,
                    max_new_tokens: int, stagger: int = 1, seed: int = 0) -> list[Request]:
    """``n_requests`` prompts with lengths uniform in [min_len, max_len] and
    uniform tokens, arriving every ``stagger`` engine ticks."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n_requests)
    return [
        Request(id=i, tokens=rng.integers(0, vocab, size=int(n), dtype=np.int32),
                max_new_tokens=max_new_tokens, arrival_step=i * stagger)
        for i, n in enumerate(lens)
    ]


def staggered_requests(cfg, n_requests: int = 12, base_len: int = 16, max_new_tokens: int = 8,
                       stagger: int = 2, seed: int = 7) -> list[Request]:
    """``n_requests`` prompts over three lengths (base/2, base, 3*base/2)
    arriving every ``stagger`` ticks; every other request gets half the
    decode budget (at least 2)."""
    lens = [max(4, base_len // 2), base_len, base_len + base_len // 2]
    return [
        Request(id=i, tokens=_draw(cfg.vocab, lens[i % len(lens)], seed + i),
                max_new_tokens=max_new_tokens if i % 2 == 0 else max(2, max_new_tokens // 2),
                arrival_step=i * stagger, extras=extras_for(cfg))
        for i in range(n_requests)
    ]


def shared_prefix_requests(cfg, n_users: int = 12, n_personas: int = 3, system_len: int = 48,
                           persona_len: int = 12, user_len: int = 8, max_new_tokens: int = 8,
                           stagger: int = 2, seed: int = 11) -> list[Request]:
    """Chat behind one system prompt: request i's prompt is ``system ++
    persona[i % n_personas] ++ user_i`` (``system_len`` tokens shared by all,
    ``persona_len`` shared within a persona, ``user_len`` unique), one
    arrival every ``stagger`` ticks."""
    system = _draw(cfg.vocab, system_len, seed)
    personas = [_draw(cfg.vocab, persona_len, seed + 1 + p) for p in range(n_personas)]
    return [
        Request(id=i, tokens=np.concatenate([system, personas[i % n_personas],
                                             _draw(cfg.vocab, user_len, seed + 100 + i)]),
                max_new_tokens=max_new_tokens, arrival_step=i * stagger,
                extras=extras_for(cfg))
        for i in range(n_users)
    ]


def sla_requests(cfg, n_requests: int = 32, base_len: int = 16, rate: float = 0.35,
                 burst_factor: float = 4.0, interactive_frac: float = 0.5,
                 max_new_interactive: int = 6, max_new_batch: int = 20,
                 seed: int = 13) -> list[Request]:
    """Open-loop bursty arrivals in two SLA classes: a two-state
    Markov-modulated Poisson process (calm: mean gap ``1/rate`` ticks; burst:
    ``burst_factor`` times hotter; ~25% chance to enter a burst, ~70% to stay
    in one), each request ``interactive`` with probability
    ``interactive_frac`` (prompts of base/2 or base tokens,
    ``max_new_interactive`` new) or ``batch`` (base, 3*base/2 or 2*base,
    ``max_new_batch`` new).  A pure function of ``seed``."""
    rng = np.random.default_rng(seed)
    short_lens = [max(4, base_len // 2), base_len]
    long_lens = [base_len, base_len + base_len // 2, 2 * base_len]
    reqs = []
    clock, burst = 0.0, False
    for i in range(n_requests):
        burst = rng.random() < (0.70 if burst else 0.25)
        clock += rng.exponential(1.0 / (rate * (burst_factor if burst else 1.0)))
        if rng.random() < interactive_frac:
            lens, new, klass = short_lens, max_new_interactive, "interactive"
        else:
            lens, new, klass = long_lens, max_new_batch, "batch"
        plen = lens[int(rng.integers(len(lens)))]
        reqs.append(Request(id=i, tokens=_draw(cfg.vocab, plen, seed + 1000 + i),
                            max_new_tokens=new, arrival_step=int(clock), req_class=klass,
                            extras=extras_for(cfg)))
    return reqs


def required_max_seq(requests) -> int:
    return max(r.prompt_len + r.max_new_tokens for r in requests)
