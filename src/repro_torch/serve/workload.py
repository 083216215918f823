"""Deterministic synthetic serving workloads, drawn with numpy from a seed."""
from __future__ import annotations

import numpy as np

from repro_torch.serve.scheduler import Request


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


def required_max_seq(requests) -> int:
    return max(r.prompt_len + r.max_new_tokens for r in requests)
