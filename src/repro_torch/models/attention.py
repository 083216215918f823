"""Dense paged attention for the serving tick (port of the dense paged
subset of ``repro/models/attention.py``).

Every sequence owns a block table into a shared KV arena.  The port's
arenas carry one extra block past the last real one, a write sink: lanes
that must not write (past a slot's ``n_valid``, or a parked slot) are aimed
at it, where the reference drops them with an out-of-bounds scatter.  No
table ever names the sink, so it is never read.  The fp write updates the
arena in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gn_paged_attention.ops import gn_paged_attention_chunk
from repro_torch.models.layers import ParamSpec
from repro_torch.models.rope import apply_rope


def attn_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": ParamSpec((d, cfg.q_features)),
        "wk": ParamSpec((d, cfg.kv_features)),
        "wv": ParamSpec((d, cfg.kv_features)),
        "wo": ParamSpec((cfg.q_features, d)),
    }


def paged_write_indices(rows, n_valid, tables, block_size: int, num_blocks: int):
    """Flattened arena rows for a (N, C) grid of absolute positions:
    physical = table[row // bs] * bs + row % bs; lanes >= n_valid go to row
    num_blocks * bs, the first row of the sink block.  The logical block is
    clamped to the table's width so a don't-care lane never indexes past it
    (its row is replaced by the sink anyway)."""
    c_len = rows.shape[1]
    log_blk = (rows // block_size).clamp(max=tables.shape[1] - 1)
    phys = torch.gather(tables.long(), 1, log_blk)
    dest = phys * block_size + rows % block_size
    lane_ok = torch.arange(c_len, device=rows.device)[None, :] < n_valid[:, None]
    return torch.where(lane_ok, dest, num_blocks * block_size).reshape(-1)


def attn_paged_chunk(cfg: ModelConfig, p: dict, arena_k, arena_v, x, positions,
                     n_valid, tables):
    """Block-paged chunked append-decode, batched over slots.

    x: (N, C, D) in the activation dtype; positions/n_valid: (N,) int32;
    tables: (N, max_bt) int32; arena_k/arena_v: (num_blocks + 1, bs, KV, dh),
    updated in place; p: the layer's attention weights in x's dtype.  Lane
    (s, i) writes absolute position positions[s] + i (if i < n_valid[s]) and
    attends [0, positions[s] + i].  Returns (N, C, D).
    """
    if cfg.softmax_impl != "gn":
        raise NotImplementedError(
            f"the paged read is the GN kernel; softmax_impl={cfg.softmax_impl!r} "
            "is not ported")
    b, c_len, _ = x.shape
    nb, bs = arena_k.shape[0] - 1, arena_k.shape[1]
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    rows = positions.long()[:, None] + torch.arange(c_len, device=x.device)[None, :]
    q = apply_rope((x @ p["wq"]).reshape(b, c_len, cfg.n_heads, dh), rows, cfg.rope_theta)
    k_new = apply_rope((x @ p["wk"]).reshape(b, c_len, kv, dh), rows, cfg.rope_theta)
    v_new = (x @ p["wv"]).reshape(b, c_len, kv, dh)

    dest = paged_write_indices(rows, n_valid, tables, bs, nb)
    arena_k.view(-1, kv, dh).index_copy_(0, dest, k_new.reshape(-1, kv, dh).to(arena_k.dtype))
    arena_v.view(-1, kv, dh).index_copy_(0, dest, v_new.reshape(-1, kv, dh).to(arena_v.dtype))

    out = gn_paged_attention_chunk(q, arena_k, arena_v, tables, positions, n_valid)
    return out.reshape(b, c_len, cfg.q_features).to(x.dtype) @ p["wo"]
