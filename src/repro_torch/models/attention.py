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
  * A prefill past ``CHUNKED_FROM`` (2048) tokens takes the GN
    flash-attention kernel, causal, where the reference takes
    ``chunked_self_attention``: the same online GN accumulation (a running
    max snapped up to the Δ grid, LUT'd rescales, one division by the sum of
    the numerators), so the (S, S) scores are never materialized.  On the
    CPU the wrapper runs its plain one-pass version, as every kernel of the
    port does there.  The reference's ``windowed_chunked`` serves sliding
    windows, which the port does not serve yet.
  * The slab cache is written in place.

Paged path: every sequence owns a block table into a shared KV arena.  The
port's arenas carry one extra block past the last real one, a write sink:
lanes that must not write (past a slot's ``n_valid``, or a parked slot) are
aimed at it, where the reference drops them with an out-of-bounds scatter.
No table ever names the sink, so it is never read.  The fp write updates
the arena in place.  With int8 arenas (``scales`` given) the write quantizes
through ``paged_quant_write``, which updates the int8 arena and the
per-block scale vectors in place; the scale vectors carry an entry for the
sink block too, set by its writes and never read.

The paged read takes one of three paths (``paged_read_path``): the GN
paged-attention kernel (``"kernel"``, the default; the reference's
``"pallas"``), or the reference's two jnp reads, taken only when
``FORCE_PAGED_READ`` names them: ``"streamed"`` gathers K one tile of
``STREAM_TILE`` table columns at a time and never holds the K stream, and
``"gathered"`` materializes each slot's K and V streams, the oracle the
streamed read is held to bit for bit.  Both keep the reference's rounding
points: scores in the activation dtype, scaled in it, then cast to f32 and
masked; the GN softmax kernel over the (N, KV, G, C, T) rows; probabilities
cast to the value dtype before P·V; int8 blocks gathered first and
dequantized in the activation dtype by their scale cast to it.

GN sentinels (``probe=True``): each layer's read also returns its probe,
which ``paged_probe_word`` turns into an (N, 3) health word a layer: the Σp
residual with nonfinite values forced to +inf, the share of the tick's int8
writes that clipped, and a scale-sanity flag over the live horizon.  The streamed and gathered reads
hold the scores and probabilities, so they give the full Σp probe; the
kernel keeps them in registers, so its probe is reduced to the finiteness
of its output, as the reference's Pallas read's (``models/attention.py``
there).  A NaN or Inf K tile turns the scores nonfinite, and the GN
exponential launders them into a valid distribution, so the reduced probe
misses K faults that the full probe catches; V faults reach the output.

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
CHUNKED_FROM = 2048  # longer prompts take the flash kernel (the reference: chunked)

# The paged read's path: None (the kernel) or "streamed" / "gathered", the
# reference's jnp reads, as its own FORCE_PAGED_READ forces them.  An engine
# fixes the path it was built under and refuses to tick after a change.
FORCE_PAGED_READ: str | None = None
READ_PATHS = ("kernel", "streamed", "gathered")
# table columns the streamed read gathers per score product (the reference
# unrolls its scan over blocks by 8): ~65 products a layer at 514 columns
STREAM_TILE = 8


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
    q, k, v = _qkv(cfg, p, x, positions)
    if s > CHUNKED_FROM:
        _require_gn(cfg)
        out = gn_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), causal=True)
        out = out.transpose(1, 2)
    else:
        out = _sdpa(cfg, q, k, v, causal_mask(s, s, x.device))
    return out.reshape(b, s, cfg.q_features) @ p["wo"], {"k": k, "v": v}


def attn_decode_step(cfg: ModelConfig, p: dict, cache: dict, x, pos):
    """One-token decode.  x: (B,1,D); pos: the position written, a 0-d int32
    tensor on x's device (as the reference traces it, so one CUDA graph
    serves every step); cache: this layer's {"k", "v"} slabs (B,T,KV,dh),
    whose slot ``pos`` is written in place.  Returns (out (B,1,D), cache)."""
    _require_gn(cfg)
    b = x.shape[0]
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    q, k_new, v_new = _qkv(cfg, p, x, pos.reshape(1, 1).expand(b, 1))
    slot = pos.reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
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


# GN sentinel: a per-block dequant scale above this is corrupt (the
# reference's SCALE_SANITY_MAX).  Legitimate scales are QUANT_MARGIN *
# amax / 127, orders of magnitude below it.
SCALE_SANITY_MAX = 1e4


def _probe_sum_residual(pmat, scores, out, valid, lane_ok):
    """Sentinel channel 0 per slot (the reference's ``_probe_sum_residual``):
    the largest |Σp − 1| over the slot's live lanes, +inf when a visible
    score or a live lane's output is nonfinite.  pmat/scores: (N, KV, G, C,
    T); out: (N, C, ...) before wo; valid: (N, C, T); lane_ok: (N, C).
    Returns (N,) f32."""
    n = pmat.shape[0]
    lane = lane_ok[:, None, None]
    sumres = (pmat.float().sum(dim=-1) - 1.0).abs()
    res = torch.where(lane, sumres, 0.0).reshape(n, -1).amax(dim=1)
    bad = (~torch.isfinite(scores)) & valid[:, None, None] & lane[..., None]
    obad = (~torch.isfinite(out.float().reshape(n, out.shape[1], -1))) & lane_ok[:, :, None]
    return torch.where(bad.reshape(n, -1).any(dim=1) | obad.reshape(n, -1).any(dim=1),
                       torch.inf, res)


def paged_probe_word(probes, positions, n_valid, tables, block_size: int, scales):
    """The tick's (L, N, 3) sentinel health words, one a layer (the
    reference's ``paged_probe_word``, which its scan builds a layer at a
    time; assembled here once a tick from each layer's ``attn_paged_chunk``
    probe, so the tick adds a few launches a layer, not a dozen).

    Channels: [0] the Σp residual, +inf on a nonfinite live value: the
    streamed and gathered reads give it per slot (``_probe_sum_residual``);
    the kernel read gives its output's row sums (N, C) f32, nonfinite
    exactly when a row holds a NaN or an Inf (a finite bf16 or f32 attention
    row is a convex mix of V rows, so its sum cannot overflow), which make
    the channel 0 or +inf; [1] the share of the slot's int8 writes this tick
    that clipped; [2] 1.0 when a scale of the slot's live horizon is
    nonfinite, negative or past SCALE_SANITY_MAX (``scales``: the (L, nb +
    1) k and v scales after the tick's writes, or None).  Parked lanes
    (n_valid = 0) read stale blocks by design: every channel is 0 there."""
    dev = positions.device
    n, layers = positions.shape[0], len(probes)
    zero = torch.zeros(layers, n, dtype=torch.float32, device=dev)
    active = (n_valid > 0)[None, :]
    probe0 = torch.stack([p for p, _ in probes])
    if probe0.dim() == 3:  # the kernel read's row sums (L, N, C)
        lane_ok = torch.arange(probe0.shape[2], device=dev)[None, :] < n_valid[:, None]
        bad = (~torch.isfinite(probe0) & lane_ok).any(dim=2)
        probe0 = torch.where(bad, torch.inf, 0.0)
    clip = scalebad = zero
    if probes[0][1] is not None:
        clip_tok = torch.stack([c for _, c in probes]).reshape(layers, n, -1)
        lane_ok = torch.arange(clip_tok.shape[2], device=dev)[None, :] < n_valid[:, None]
        clip = (clip_tok & lane_ok).float().sum(dim=2) / n_valid.clamp_min(1).float()
    if scales is not None:
        max_blk = (positions.long() + n_valid.long().clamp_min(1) - 1) // block_size
        blk_ok = torch.arange(tables.shape[1], device=dev)[None, :] <= max_blk[:, None]
        s_at = torch.stack(scales)[:, :, tables.long()]  # (2, L, N, H')
        bad = (~torch.isfinite(s_at)) | (s_at < 0) | (s_at > SCALE_SANITY_MAX)
        scalebad = (bad & blk_ok).any(dim=3).any(dim=0).float()
    return torch.stack([torch.where(active, ch, zero) for ch in (probe0, clip, scalebad)], dim=2)


# Headroom on the first-write per-block amax (the reference's QUANT_MARGIN):
# a block's scale is frozen at its offset-0 write and later appends to the
# block saturate at +-127 rather than rescale.
QUANT_MARGIN = 2.0


def paged_quant_write(flat_arena, scale, new_vals, dest, block_size: int,
                      return_clip: bool = False):
    """Freeze-at-first-write int8 block scatter, in place (port of the
    reference's ``paged_quant_write``, ``models/attention.py:331``).

    flat_arena: ((nb + 1) * bs, ...) int8, the sink block last; scale:
    (nb + 1,) f32 per-block scales; new_vals: (n_tok, ...) fp values for the
    flattened arena rows ``dest`` (n_tok,), dropped lanes aimed at the sink.
    A block that takes a write at in-block offset 0 this call (re)sets its
    scale to QUANT_MARGIN * (the amax of every write into it this call) /
    127; every write is quantized by its block's scale after that update,
    rounded half to even and clipped to +-127.  On the same f32 inputs the
    real blocks' int8 values and scales equal the reference's bit for bit.
    With ``return_clip`` it returns an (n_tok,) bool of the writes that
    saturated (the sentinels' clip channel), else None: a write saturates
    when its largest |value| over the scale rounds past 127, which is the
    reference's any(|round(x / s)| > 127) (rounding is monotone)."""
    blk = dest // block_size
    x = new_vals.float()
    amax = x.abs().reshape(x.shape[0], -1).amax(dim=1)  # (n_tok,)
    blk_amax = torch.zeros_like(scale).scatter_reduce_(0, blk, amax, "amax")
    at_zero = (dest % block_size == 0).to(scale.dtype)
    first = torch.zeros_like(scale).scatter_reduce_(0, blk, at_zero, "amax") > 0
    # the divisor is a tensor filled on the device: PyTorch on CUDA divides
    # by a Python scalar as a multiply by its reciprocal, which can round
    # 1 ulp apart from the IEEE quotient the reference and the CPU take
    frozen = QUANT_MARGIN * blk_amax / torch.full_like(blk_amax, 127.0)
    scale.copy_(torch.where(first, frozen, scale))
    s_tok = scale[blk]
    denom = torch.where(s_tok > 0, s_tok, 1.0)
    q = torch.round(x / denom.reshape((-1,) + (1,) * (x.dim() - 1)))
    flat_arena.index_copy_(0, dest, torch.clamp(q, -127.0, 127.0).to(torch.int8))
    if return_clip:
        return torch.round(amax / denom) > 127.0
    return None


def paged_read_path(cfg: ModelConfig) -> str:
    """The paged read a tick takes (port of the reference's
    ``paged_read_path``): ``FORCE_PAGED_READ`` when set, else ``"kernel"``,
    the GN paged-attention kernel.  The reference serves its Pallas kernel
    only under ``use_pallas``; the port has no such switch."""
    _require_gn(cfg)
    if FORCE_PAGED_READ is None:
        return "kernel"
    if FORCE_PAGED_READ not in READ_PATHS:
        raise ValueError(f"FORCE_PAGED_READ must be None or one of {READ_PATHS}, got "
                         f"{FORCE_PAGED_READ!r}")
    return FORCE_PAGED_READ


def _gather_blocks(arena, scale, tables, dt):
    """arena[tables]: (N, H', bs, KV, dh) blocks, int8 ones (``scale`` given)
    dequantized after the gather in ``dt`` by their block's scale cast to
    ``dt``, as the reference's reads dequantize."""
    blocks = arena[tables]
    if scale is None:
        return blocks
    return blocks.to(dt) * scale[tables].to(dt)[..., None, None, None]


def _paged_read_plain(q, arena_k, arena_v, tables, rows, scales, streamed: bool,
                      probe_nv=None):
    """The reference's streamed (``_stream_paged_tiles``) or gathered read.

    q: (N, C, H, dh) rotated, in the activation dtype; arenas (nb + 1, bs,
    KV, dh); tables: (N, H') int32; rows: (N, C) absolute positions; scales:
    (k_scale, v_scale) for int8 arenas, else None.  The streamed read
    gathers K ``STREAM_TILE`` table columns at a time and emits each tile's
    scores, which are the gathered read's dots column for column; both run
    the same softmax and the same P·V over the horizon's V blocks.  Returns
    (N, C, H * dh) in the value dtype; with ``probe_nv`` (the tick's n_valid)
    also the full Σp probe (``_probe_sum_residual``) of its scores and
    probabilities, as the reference's two reads return it."""
    n, c_len, h, dh = q.shape
    kv = arena_k.shape[2]
    dt = q.dtype
    qg = q.reshape(n, c_len, kv, h // kv, dh)
    tables = tables.long()
    k_scale, v_scale = scales if scales is not None else (None, None)
    if streamed:
        scores = torch.cat([
            _scaled_scores(qg, _gather_blocks(arena_k, k_scale, tbl, dt).reshape(n, -1, kv, dh),
                           dh)
            for tbl in tables.split(STREAM_TILE, dim=1)], dim=-1)
    else:
        k_at = _gather_blocks(arena_k, k_scale, tables, dt).reshape(n, -1, kv, dh)
        scores = _scaled_scores(qg, k_at, dh)
    valid = torch.arange(scores.shape[-1], device=q.device)[None, None, :] <= rows[:, :, None]
    scores = torch.where(valid[:, None, None], scores.float(), NEG_INF)
    v_at = _gather_blocks(arena_v, v_scale, tables, dt).reshape(n, -1, kv, dh)
    pmat = gn_softmax(scores).to(v_at.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", pmat, v_at)
    if probe_nv is None:
        return out.reshape(n, c_len, h * dh)
    lane_ok = torch.arange(c_len, device=q.device)[None, :] < probe_nv[:, None]
    return out.reshape(n, c_len, h * dh), _probe_sum_residual(pmat, scores, out, valid, lane_ok)


def attn_paged_chunk(cfg: ModelConfig, p: dict, arena_k, arena_v, x, positions,
                     n_valid, tables, scales=None, probe: bool = False):
    """Block-paged chunked append-decode, batched over slots.

    x: (N, C, D) in the activation dtype; positions/n_valid: (N,) int32;
    tables: (N, max_bt) int32; arena_k/arena_v: (num_blocks + 1, bs, KV, dh),
    updated in place; p: the layer's attention weights in x's dtype.  Lane
    (s, i) writes absolute position positions[s] + i (if i < n_valid[s]) and
    attends [0, positions[s] + i].  ``scales`` = (k_scale, v_scale), each
    (num_blocks + 1,) f32 and updated in place, marks the arenas as int8:
    the writes quantize, the read dequantizes per block.  The read takes
    ``paged_read_path(cfg)``.  Returns (N, C, D); with ``probe`` also this
    layer's sentinel probe (probe0, clip), which ``paged_probe_word`` turns
    into the layer's health word: probe0 the full Σp probe (N,) of the
    streamed and gathered reads, or the kernel read's output row sums (N,
    C) f32 (its finiteness); clip the (N * C,) int8 writes that saturated,
    or None over fp arenas.
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
    clips = []
    for arena, new, scale in zip((arena_k, arena_v), (k_new, v_new), scales or (None, None)):
        flat, vals = arena.view(-1, kv, dh), new.reshape(-1, kv, dh)
        if scale is None:
            flat.index_copy_(0, dest, vals.to(arena.dtype))
        else:
            clips.append(paged_quant_write(flat, scale, vals, dest, bs, return_clip=probe))

    path = paged_read_path(cfg)
    if path == "kernel":
        out = gn_paged_attention_chunk(q, arena_k, arena_v, tables, positions, n_valid,
                                       scales=scales)
        if probe:  # reduced probe: the probabilities stay in the kernel
            probe0 = out.reshape(b, c_len, -1).sum(dim=-1, dtype=torch.float32)
    else:
        out = _paged_read_plain(q, arena_k, arena_v, tables, rows, scales,
                                streamed=path == "streamed", probe_nv=n_valid if probe else None)
        if probe:
            out, probe0 = out
    out = out.reshape(b, c_len, cfg.q_features).to(x.dtype) @ p["wo"]
    if not probe:
        return out
    return out, (probe0, clips[0] | clips[1] if clips else None)
