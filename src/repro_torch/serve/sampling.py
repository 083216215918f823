"""Counter-based sampling for the serving paths (the port's counterpart of
the reference's ``jax.random.categorical`` draws in ``serve/engine.py``).

A token is drawn by Gumbel-max: ``argmax(logits / T + g)`` with one Gumbel
variate ``g = -log(-log(u))`` per vocabulary entry, which draws exactly
from ``softmax(logits / T)``.  The uniform ``u`` is a hash of a counter, not
the state of a generator: (seed, stream, position, vocabulary index), where
the engine's stream is the request id and ``generate``'s is the batch row,
and the position is the absolute position the drawn token is written at.
So a draw is a pure function of torch ops on the device, captured with the
tick into its CUDA graph with no generator state to replay; a reset replay
and a recompute resume draw the same tokens; and a draw does not depend on
the slot, the batch or the tick it lands in.

The hash works on 32-bit words held in int64: every product is of a word
below 2^32 and a constant below 2^31, so it stays under 2^63 and the bits are
the same on the CPU and on the card.  The mixer is the two-multiply
xorshift-multiply hash of Wellons' hash-prospector (constants 0x21f0aaad,
0x735a2d97).  The draw cannot match ``jax.random``; the tests compare
distributions with the JAX package, not tokens.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """One round of the 32-bit mixer on int64 words in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK
    return x ^ (x >> 15)


def counter_bits(seed: int, streams: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(N, vocab) int64 words in [0, 2^32): the hash of (seed, streams[n],
    positions[n], v) for every row n and vocabulary index v."""
    dev = streams.device
    key = _mix(torch.full_like(streams, int(seed) & _MASK, dtype=torch.int64))
    key = _mix(key ^ (streams.long() & _MASK))
    key = _mix(key ^ (positions.long() & _MASK))
    cols = _mix(torch.arange(vocab, device=dev, dtype=torch.int64))
    return _mix(key[:, None] ^ cols[None, :])


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel variates (f32) of hash words: the top 24 bits make a uniform
    u = (b + 1/2) / 2^24 in (0, 1), exact in f32, and g = -log(-log(u))."""
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, temps: torch.Tensor, seed: int, streams: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Next token per row (int64): drawn from softmax(logits / T) where the
    row's temperature T > 0, the argmax where T = 0 (greedy), as the
    reference's ``_sample_next``.  logits: (N, V) f32; temps: (N,) f32;
    streams, positions: (N,) ints keying each row's draw."""
    greedy = logits.argmax(dim=-1)
    tsafe = torch.where(temps > 0, temps, 1.0)
    g = gumbel(counter_bits(seed, streams, positions, logits.shape[-1]))
    drawn = (logits / tsafe[:, None] + g).argmax(dim=-1)
    return torch.where(temps > 0, drawn, greedy)
