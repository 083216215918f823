"""Rotary position embeddings (port of ``repro/models/rope.py``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions broadcastable to (..., S).

    Angles, cos and sin are f32; the products promote x to f32 before the
    cast back, as jnp's type promotion does in the reference."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x.dim() == angles.dim() + 1:  # (..., S, H, D): broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
