"""Dense GN attention (port of the dense full-attention subset of
``repro/models/attention.py``): the contiguous paths of training-style
scoring, static prefill and slab decode, and the block-paged serving tick.

Contiguous paths:
  * ``self_attention`` (``Model.forward``) runs the GN flash-attention
    kernel on every call.  The reference takes its Pallas kernel only under
    ``cfg.use_pallas`` and the one-pass ``_sdpa`` otherwise; the two compute
    the same function, and the port reads no ``use_pallas``.
  * ``attn_prefill`` and ``attn_decode_step`` keep the reference's one-pass
    form: scores by ``torch.matmul`` scaled in the activation dtype, cast to
    f32, masked at -1e30, then the GN softmax kernel over each score row.
    Prefill past 2048 tokens takes ``chunked_self_attention`` in the
    reference; the port refuses it.
  * The slab cache is written in place.

Paged path: every sequence owns a block table into a shared KV arena.  The
port's arenas carry one extra block past the last real one, a write sink:
lanes that must not write (past a slot's ``n_valid``, or a parked slot) are
aimed at it, where the reference drops them with an out-of-bounds scatter.
No table ever names the sink, so it is never read.  The fp write updates
the arena in place.

Only the GN softmax is ported (``softmax_impl="gn"``), and no sliding
window.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gn_attention.ops import gn_attention
from repro_torch.kernels.gn_paged_attention.ops import gn_paged_attention_chunk
from repro_torch.kernels.gn_softmax.ops import gn_softmax
from repro_torch.models.layers import ParamSpec
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30
CHUNKED_FROM = 2048  # longer prompts take chunked attention in the reference


def attn_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": ParamSpec((d, cfg.q_features)),
        "wk": ParamSpec((d, cfg.kv_features)),
        "wv": ParamSpec((d, cfg.kv_features)),
        "wo": ParamSpec((cfg.q_features, d)),
    }


def _require_gn(cfg: ModelConfig) -> None:
    if cfg.softmax_impl != "gn":
        raise NotImplementedError(
            f"the port's attention runs the GN kernels; softmax_impl={cfg.softmax_impl!r} "
            "is not ported")


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _scaled_scores(qg, k, head_dim):
    """(B,S,KV,G,dh) x (B,T,KV,dh) -> (B,KV,G,S,T) scores times head_dim^-0.5,
    in the activation dtype, the scale rounded to that dtype first as jnp
    rounds a Python float; the caller casts to f32 after the scaling."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return scores * torch.tensor(head_dim ** -0.5, dtype=scores.dtype)


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q: (B,S,H,dh), k/v: (B,T,KV,dh), mask: (B,1,S,T) or (1,1,S,T) bool.
    One-pass GN attention through the softmax kernel."""
    _require_gn(cfg)
    b, s, h, dh = q.shape
    kv = k.shape[2]
    scores = _scaled_scores(q.reshape(b, s, kv, h // kv, dh), k, dh).float()
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    p = gn_softmax(scores).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", p, v).reshape(b, s, h, dh)


def causal_mask(s: int, t: int, device=None):
    """(1, 1, s, t) bool; t >= s (the query block is the suffix of the kv span)."""
    rows = torch.arange(s, device=device)[:, None] + (t - s)
    cols = torch.arange(t, device=device)[None, :]
    return (cols <= rows)[None, None]


def _qkv(cfg: ModelConfig, p: dict, x, positions):
    """Rotated q (B,S,H,dh) and k, and v (B,S,KV,dh); p holds x's dtype."""
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v)


def self_attention(cfg: ModelConfig, p: dict, x, positions, causal: bool = True):
    """x: (B, S, D), positions: (B, S) -> (B, S, D) through the GN
    flash-attention kernel (q, k, v moved to its (B, heads, S, dh) layout)."""
    _require_gn(cfg)
    b, s, _ = x.shape
    q, k, v = (t.transpose(1, 2).contiguous() for t in _qkv(cfg, p, x, positions))
    out = gn_attention(q, k, v, causal=causal)
    return out.transpose(1, 2).reshape(b, s, cfg.q_features) @ p["wo"]


# ------------------------------------------------------------ slab cache --
def attn_cache_shape(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """One layer's slab cache leaves, name -> (shape, dtype): a slot per
    position (full attention, no window)."""
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": (kv, dt), "v": (kv, dt)}


def attn_prefill(cfg: ModelConfig, p: dict, x, positions):
    """Self-attention over the prompt; returns (out (B,S,D), {"k", "v"}:
    (B,S,KV,dh) for the cache)."""
    b, s, _ = x.shape
    if s > CHUNKED_FROM:
        raise NotImplementedError(
            f"a prefill of {s} > {CHUNKED_FROM} tokens takes chunked_self_attention in the "
            "reference, which is not ported yet (ROADMAP Queue A)")
    q, k, v = _qkv(cfg, p, x, positions)
    out = _sdpa(cfg, q, k, v, causal_mask(s, s, x.device)).reshape(b, s, cfg.q_features)
    return out @ p["wo"], {"k": k, "v": v}


def attn_decode_step(cfg: ModelConfig, p: dict, cache: dict, x, pos: int):
    """One-token decode.  x: (B,1,D); pos: the position written, a Python
    int; cache: this layer's {"k", "v"} slabs (B,T,KV,dh), whose slot
    ``pos`` is written in place.  Returns (out (B,1,D), cache)."""
    _require_gn(cfg)
    b = x.shape[0]
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(cfg, p, x, posv)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    valid = torch.arange(k.shape[1], device=x.device) <= pos
    scores = _scaled_scores(q.reshape(b, 1, kv, cfg.n_heads // kv, dh), k, dh).float()
    scores = torch.where(valid, scores, NEG_INF)
    pmat = gn_softmax(scores).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", pmat, v).reshape(b, 1, cfg.q_features)
    return out @ p["wo"], cache


# ------------------------------------------------------------ paged tick --
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
    _require_gn(cfg)
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
