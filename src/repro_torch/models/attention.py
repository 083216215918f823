"""Dense GN attention (port of the decoder subset of
``repro/models/attention.py``): the contiguous paths of training-style
scoring, static prefill and slab decode, the slab serving tick, and the
block-paged serving tick; full attention or a sliding window
(``cfg.sliding_window``, mixtral).

The softmax is ``cfg.softmax_impl``, any name of ``core.get_softmax``:
``"gn"`` (the paper's Algorithm 1) runs through the port's GN kernels (at
the one-pass score sites, ``_score_softmax``: one launch of the GN softmax
kernel's fused entry over the raw score product, which scales, casts,
masks, normalizes and casts back as the chain below does);
every other name (the exact FP32 softmax, the bit-accurate ``gn_hwsim``,
the prior-work baselines of Table II) runs its ``core`` function in plain
torch, as the reference computes them in jnp outside any Pallas kernel.
An unknown name raises ``KeyError``, as the reference's ``get_softmax``.

Contiguous paths:
  * ``self_attention`` (``Model.forward``, the training forward) runs the
    GN flash-attention kernel on every GN call.  The reference takes its
    Pallas kernel only under ``cfg.use_pallas`` and the one-pass ``_sdpa``
    otherwise; the two compute the same function, and the port reads no
    ``use_pallas``.  Every other softmax runs the one-pass ``_sdpa``.
  * ``attn_prefill`` and ``attn_decode_step`` keep the reference's one-pass
    form: scores by ``torch.matmul`` scaled in the activation dtype, cast to
    f32, masked at -1e30, then the softmax over each score row, cast to v's
    dtype (for GN all of it after the product in one fused kernel launch,
    bit for bit the chain; the ``core`` function of the other names).
  * A GN prefill or forward past ``CHUNKED_FROM`` (2048) tokens takes the GN
    flash-attention kernel, causal, where the reference takes
    ``chunked_self_attention``: the same online GN accumulation (a running
    max snapped up to the Δ grid, LUT'd rescales, one division by the sum of
    the numerators), so the (S, S) scores are never materialized.  On the
    CPU the wrapper runs its plain one-pass version, as every kernel of the
    port does there.  A sliding window goes to the kernel as its ``window``
    band on every call, where the reference takes ``windowed_chunked`` past
    the window (and ``causal_chunked``, the same function, below it).
  * Exact attention past ``CHUNKED_FROM`` tokens takes
    ``chunked_attention.chunked_self_attention`` in plain torch, as the
    reference does.  The one-pass-only names (``gn_hwsim`` and the
    baselines) stay one-pass at every length, as the reference's
    ``_use_chunked`` keeps them, so the (S, S) scores are materialized.
  * The slab cache is written in place.  With a sliding window it is a ring
    of ``min(max_seq, window)`` slots (``attn_cache_shape``): position p
    lives in slot p % slots, a prefill past the window keeps its last
    ``window`` keys rotated into place, and a decode step masks the ring by
    age, as the reference's.

Slab serving tick (``ContinuousEngine(paged=False)``, the pool for sliding
windows): ``attn_slab_chunk`` is the reference's ``attn_decode_chunk`` and
``attn_slab_decode`` its ``attn_decode_step``, each batched over the slots
with a position and a lane count per slot (the reference vmaps them over
the slots).  A lane that must not write (past ``n_valid``, a parked slot)
writes back the value its ring slot already holds, so the pool needs no
sink: a chunk's C <= slots lanes land in C distinct slots.  A windowed chunk
attends the pre-write ring and its own keys side by side, as the reference's.

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
paged-attention kernel (``"kernel"``, the default for GN; the reference's
``"pallas"``), or the reference's two jnp reads, the streamed one the
default for the exact softmax and the gathered one for the one-pass-only
names (the kernel is GN-only), either taken for GN
only when ``FORCE_PAGED_READ`` names it: ``"streamed"`` gathers K one tile of
``STREAM_TILE`` table columns at a time and never holds the K stream, and
``"gathered"`` materializes each slot's K and V streams, the oracle the
streamed read is held to bit for bit.  Both keep the reference's rounding
points: scores in the activation dtype, scaled in it, then cast to f32 and
masked; the GN softmax kernel over the (N, KV, G, C, T) rows (with the
scale, cast and mask, its fused entry); probabilities cast to the value
dtype before P·V; int8 blocks gathered first and
dequantized in the activation dtype by their scale cast to it; the softmax
of ``cfg.softmax_impl``.

GN sentinels (``probe=True``): each layer's read also returns its probe,
which ``paged_probe_word`` turns into an (N, 3) health word a layer: the Σp
residual with nonfinite values forced to +inf, the share of the tick's int8
writes that clipped, and a scale-sanity flag over the live horizon.  The streamed and gathered reads
hold the scores and probabilities, so they give the full Σp probe; the
kernel keeps them in registers, so its probe is the finiteness of its
output (V faults reach it) and its per-row flag of a nonfinite live score
(K faults: the GN exponential launders nonfinite scores into a valid
distribution, so the output alone misses them, as the reference's Pallas
read's reduced probe does; the reference's default engine reads through
the streamed path, whose full probe sees the scores).

Cross-attention (the encoder-decoder and VLM families): ``cross_attention``
projects the memory (the encoder's output, or the VLM's projected patches)
to k and v and attends it from every query row, no rope and no mask;
``project_cross_kv`` and ``cross_attend_cached`` split it for the serving
paths, which project each request's memory once at admission and attend the
cached k and v on every tick.  Scores in the activation dtype times the
scale, cast to f32, then the softmax of ``cfg.softmax_impl`` (the GN
kernel), as ``_sdpa``.

The paged tick serves no sliding window: a windowed model has no pageable
KV (``Model.supports_paging``), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import get_softmax
from repro_torch.kernels.gn_attention.ops import CHUNKED_FROM, gn_attention
from repro_torch.kernels.gn_paged_attention.ops import gn_paged_attention_chunk
from repro_torch.kernels.gn_softmax.ops import gn_softmax, gn_softmax_scores
from repro_torch.kernels.gn_softmax.ref import scores_chain
from repro_torch.models.chunked_attention import chunked_self_attention
from repro_torch.models.layers import ParamSpec
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import (current_ctx, is_dtensor, local_kernel, local_offset,
                                           shard)

NEG_INF = -1e30
# CHUNKED_FROM (2048, ``kernels/gn_attention/ops.py``): longer prompts take the
# flash kernel (GN) or ``chunked_self_attention`` (exact), as the reference

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
        "wq": ParamSpec((d, cfg.q_features), ("embed_fsdp", "heads_tp")),
        "wk": ParamSpec((d, cfg.kv_features), ("embed_fsdp", "heads_tp")),
        "wv": ParamSpec((d, cfg.kv_features), ("embed_fsdp", "heads_tp")),
        "wo": ParamSpec((cfg.q_features, d), ("heads_tp", "embed_fsdp")),
    }


def _softmax(cfg: ModelConfig):
    """The row softmax of ``cfg.softmax_impl`` (the reference's
    ``get_softmax``): the GN kernel's wrapper for ``"gn"``, else the
    ``core`` function of the name (``KeyError`` for an unknown one)."""
    if cfg.softmax_impl == "gn":
        return _local_softmax
    return get_softmax(cfg.softmax_impl)


def _local_softmax(x):
    """``gn_softmax`` over rows (..., N); under a sharding context over local
    shards, the leading dim on the batch axes and each whole row on every
    rank."""
    rows = ("batch", *([None] * (x.dim() - 1)))
    return local_kernel(gn_softmax, (x,), (rows,), rows)


def _long_exact(cfg: ModelConfig, s: int) -> bool:
    """Whether the exact softmax streams over kv chunks at length ``s``
    (the reference's ``_use_chunked`` for the non-GN name it covers)."""
    return s > CHUNKED_FROM and cfg.softmax_impl == "exact"


def _split_heads(x, n_heads, head_dim):
    """(B, S, heads * dh) -> (B, S, heads, dh).  Under a sharding context a
    feature dim split over a mesh axis that does not divide the heads is
    gathered first (DTensor splits no head), as XLA reshards it."""
    b, s, _ = x.shape
    ctx = current_ctx()
    if (ctx is not None and is_dtensor(x)
            and ctx.spec_for_shape((b, s, n_heads, head_dim), ("batch", "seq", "heads_act", None))[2]
            is None):
        x = shard(x, "batch", "seq", None)
    return x.reshape(b, s, n_heads, head_dim)


def _grouped(q, kv: int):
    """(B, S, H, dh) -> (B, S, KV, H // KV, dh): the q heads of each kv head.
    Under a sharding context a head dim split over a mesh axis that does
    not divide the kv heads is gathered first (DTensor splits no group)."""
    b, s, h, dh = q.shape
    ctx = current_ctx()
    if (ctx is not None and is_dtensor(q)
            and ctx.spec_for_shape((b, s, kv, h // kv, dh),
                                   ("batch", "seq", "heads_act", None, None))[2] is None):
        q = shard(q, "batch", "seq", None, None)
    return q.reshape(b, s, kv, h // kv, dh)


def _merge_heads(out, features: int):
    """(B, S, heads, dh) -> (B, S, heads * dh).  Under a sharding context
    with heads that no mesh axis splits, the merge runs on local shards
    (``local_kernel``), so that its backward gathers a gradient that comes
    back split along the features before unmerging it (DTensor splits no
    head unevenly)."""
    b, s = out.shape[:2]
    ctx = current_ctx()
    axes = ("batch", "seq", "heads_act", None)
    if (ctx is None or not is_dtensor(out)
            or ctx.spec_for_shape(tuple(out.shape), axes)[2] is not None):
        return out.reshape(b, s, features)
    return local_kernel(lambda t: t.reshape(t.shape[0], t.shape[1], features), (out,),
                        (("batch", "seq", None, None),), ("batch", "seq", None))


def _score_product(qg, k):
    """(B,S,KV,G,dh) x (B,T,KV,dh) -> (B,KV,G,S,T) raw scores in the
    activation dtype, before the scale (``_score_softmax`` applies it)."""
    return torch.einsum("bskgd,btkd->bkgst", qg, k)


def _score_softmax(impl: str, scores, scale: float, mask, dtype):
    """The probabilities of a raw score product: ``scores * scale`` in the
    scores' dtype (the scale rounded to it first, as jnp rounds a Python
    float), cast to f32, -1e30 where the bool ``mask`` (broadcastable, or
    None) is False, the row softmax of ``impl``, cast to ``dtype`` (v's).
    GN: one launch of the fused kernel (``gn_softmax_scores``); every other
    name runs that chain with its ``core`` function."""
    if impl == "gn":
        axes = ("batch", "heads_act", None, None, None)[:scores.dim()]
        return local_kernel(lambda s, m: gn_softmax_scores(s, scale, m, dtype),
                            (scores, mask), (axes, None if mask is None else axes), axes)
    return scores_chain(scores, scale, mask, dtype, get_softmax(impl))


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q: (B,S,H,dh), k/v: (B,T,KV,dh), mask: (B,1,S,T) or (1,1,S,T) bool.
    One-pass attention through the softmax of ``cfg.softmax_impl``."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    scores = _score_product(_grouped(q, kv), k)
    p = _score_softmax(cfg.softmax_impl, scores, dh ** -0.5, mask[:, :, None], v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", p, v).reshape(b, s, h, dh)


def causal_mask(s: int, t: int, device=None, window: int = 0):
    """(1, 1, s, t) bool; t >= s (the query block is the suffix of the kv
    span); a sliding ``window`` keeps each row's last ``window`` columns."""
    rows = torch.arange(s, device=device)[:, None] + (t - s)
    cols = torch.arange(t, device=device)[None, :]
    m = cols <= rows
    if window:
        m &= cols > rows - window
    return m[None, None]


def _qkv(cfg: ModelConfig, p: dict, x, positions):
    """Rotated q (B,S,H,dh) and k, and v (B,S,KV,dh); p holds x's dtype."""
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    return (apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta),
            v)


def local_flash(q, k, v, causal: bool, window: int = 0, sm_scale: float | None = None):
    """``gn_attention`` over (B, heads, S, dh) q, k, v; under a sharding
    context over local shards: batch on its axes, heads on ``heads_act``
    (for q, k and v alike, so a rank's q heads read its own kv heads: a
    mesh axis that does not divide the kv heads shards no heads)."""
    def fn(q, k, v):
        return gn_attention(q, k, v, causal=causal, sm_scale=sm_scale, window=window)

    heads = ("batch", "heads_act", None, None)
    ctx = current_ctx()
    if ctx is not None and ctx.spec_for_shape(tuple(k.shape), heads)[1] is None:
        heads = ("batch", None, None, None)
    return local_kernel(fn, (q, k, v), (heads,) * 3, heads)


def self_attention(cfg: ModelConfig, p: dict, x, positions, causal: bool = True):
    """x: (B, S, D), positions: (B, S) -> (B, S, D): GN through the
    flash-attention kernel (q, k, v moved to its (B, heads, S, dh) layout;
    differentiable, ``kernels/gn_attention/ops.py``, a sliding window its
    band), the exact softmax past ``CHUNKED_FROM`` through the chunked
    stream, every other softmax through the one-pass ``_sdpa`` in plain
    torch.  ``causal=False`` (the encoder) attends every position."""
    b, s, _ = x.shape
    _softmax(cfg)
    q, k, v = _qkv(cfg, p, x, positions)
    win = cfg.sliding_window if causal else 0
    if cfg.softmax_impl == "gn":
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out = local_flash(q, k, v, causal, win).transpose(1, 2)
    elif _long_exact(cfg, s):
        out = chunked_self_attention(cfg, q, k, v, causal)
    else:
        mask = causal_mask(s, s, x.device, win) if causal else torch.ones(
            1, 1, s, s, dtype=torch.bool, device=x.device)
        out = _sdpa(cfg, q, k, v, mask)
    return _merge_heads(out, cfg.q_features) @ p["wo"]


# ------------------------------------------------------------ cross-attn --
def cross_attn_specs(cfg: ModelConfig) -> dict:
    return attn_specs(cfg)


def project_cross_kv(cfg: ModelConfig, p: dict, memory):
    """memory (B, M, D) in the activation dtype -> k, v (B, M, KV, dh)."""
    return (_split_heads(memory @ p["wk"], cfg.n_kv_heads, cfg.head_dim),
            _split_heads(memory @ p["wv"], cfg.n_kv_heads, cfg.head_dim))


def cross_attend_cached(cfg: ModelConfig, p: dict, x, k, v):
    """x (B, S, D) attends the memory's projected k, v (B, M, KV, dh), every
    row every column: (B, S, D)."""
    b, s, _ = x.shape
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    scores = _score_product(_grouped(q, kv), k)
    pmat = _score_softmax(cfg.softmax_impl, scores, dh ** -0.5, None, v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", pmat, v).reshape(b, s, cfg.q_features)
    return out @ p["wo"]


def cross_attention(cfg: ModelConfig, p: dict, x, memory):
    """x (B, S, D) queries, memory (B, M, D) encoder or vision states (no
    rope) -> (B, S, D)."""
    k, v = project_cross_kv(cfg, p, memory.to(x.dtype))
    return cross_attend_cached(cfg, p, x, k, v)


# ------------------------------------------------------------ slab cache --
def attn_cache_shape(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """One layer's slab cache leaves, name -> (shape, dtype): a slot per
    position, or with a sliding window a ring of min(max_seq, window)."""
    win = cfg.sliding_window or 0
    slots = min(max_seq, win) if win else max_seq
    kv = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": (kv, dt), "v": (kv, dt)}


def attn_prefill(cfg: ModelConfig, p: dict, x, positions):
    """Self-attention over the prompt; returns (out (B,S,D), {"k", "v"}:
    (B,S,KV,dh) for the cache, or with a sliding window shorter than the
    prompt its last ``window`` positions)."""
    b, s, _ = x.shape
    win = cfg.sliding_window or 0
    q, k, v = _qkv(cfg, p, x, positions)
    if s > CHUNKED_FROM and cfg.softmax_impl == "gn":
        out = local_flash(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), True,
                          win).transpose(1, 2)
    elif _long_exact(cfg, s):
        out = chunked_self_attention(cfg, q, k, v, True)
    else:
        out = _sdpa(cfg, q, k, v, causal_mask(s, s, x.device, win))
    if win and s > win:
        k, v = k[:, -win:], v[:, -win:]
    return out.reshape(b, s, cfg.q_features) @ p["wo"], {"k": k, "v": v}


def attn_decode_step(cfg: ModelConfig, p: dict, cache: dict, x, pos):
    """One-token decode.  x: (B,1,D); pos: the position written, a 0-d int32
    tensor on x's device (as the reference traces it, so one CUDA graph
    serves every step); cache: this layer's {"k", "v"} slabs (B,T,KV,dh),
    whose slot ``pos`` (with a sliding window ``pos % T``, a ring) is
    written in place: the slab tick's decode with every row at ``pos``.
    Returns (out (B,1,D), cache)."""
    b = x.shape[0]
    live = torch.ones(b, dtype=torch.bool, device=x.device)
    return attn_slab_decode(cfg, p, cache, x, pos.reshape(1).expand(b), live), cache


def _ring_valid(cfg: ModelConfig, slots: int, slot, pos):
    """The decode step's visible slab slots after its write, ``pos`` and
    ``slot`` (its write slot) broadcast against (slots,): [0, pos] of a full
    cache; of a ring the entries younger than the window that exist (the
    reference's age mask)."""
    idx = torch.arange(slots, device=pos.device)
    if not cfg.sliding_window:
        return idx <= pos
    age = (slot - idx) % slots  # 0 = the newest
    return (age < cfg.sliding_window) & (age <= pos)


def _attend_slab(cfg: ModelConfig, p: dict, q, k, v, valid):
    """q (N, C, H, dh) against k/v (N, T, KV, dh), ``valid`` broadcastable
    to (N, C, T): scores in the activation dtype, f32 after the scale,
    masked at -1e30, the softmax of ``cfg.softmax_impl`` (the GN kernel,
    the whole chain in one launch), probabilities cast to v's dtype;
    projected by wo: (N, C, D)."""
    n, c_len = q.shape[:2]
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    if is_dtensor(q):  # a slab split along its slots (kv_seq): every head of the rows' q
        q = shard(q, "batch", None, None, None)
    scores = _score_product(_grouped(q, kv), k)
    pmat = _score_softmax(cfg.softmax_impl, scores, dh ** -0.5, valid[:, None, None], v.dtype)
    if is_dtensor(pmat):  # the probabilities split as the slab's slots, for P·V
        pmat = shard(pmat, "batch", None, None, None, "kv_seq")
    out = torch.einsum("bkgst,btkd->bskgd", pmat, v).reshape(n, c_len, cfg.q_features)
    return out @ p["wo"]


# ------------------------------------------------------------ slab tick --
def slab_write(slab, new, dest, lane_ok) -> None:
    """Write ``new`` (N, C, ...) into ``slab`` (N, T, ...) at slots ``dest``
    (N, C), distinct within a row, in place; a lane off ``lane_ok`` (N, C)
    writes back the value its slot holds."""
    if is_dtensor(slab):
        return _slab_write_sharded(slab, new, dest, lane_ok)
    n, t = slab.shape[:2]
    flat = slab.view(n * t, *slab.shape[2:])
    idx = (torch.arange(n, device=slab.device)[:, None] * t + dest).reshape(-1)
    keep = lane_ok.reshape(-1, *([1] * (slab.dim() - 2)))
    vals = new.reshape(-1, *slab.shape[2:]).to(slab.dtype)
    flat.index_copy_(0, idx, torch.where(keep, vals, flat.index_select(0, idx)))


def _slab_write_sharded(slab, new, dest, lane_ok) -> None:
    """``slab_write`` into a DTensor slab under a sharding context (the
    static decode step over a cache split by ``cache_logical_axes``): each
    rank writes the lanes whose row and slot fall in its own shard, into
    its local slab, with no communication; ``new`` is first placed as the
    slab's rows and heads.  One lane a row (a decode step): a lane outside
    the shard is clamped onto a slot its own row writes back unchanged."""
    from torch.distributed.tensor import Replicate, Shard

    if new.shape[1] != 1:
        raise NotImplementedError("a sharded slab takes one lane a row (the decode step)")
    local = slab.to_local()
    n_loc, t_loc = local.shape[:2]
    row0, slot0 = local_offset(tuple(slab.shape), slab.placements, slab.device_mesh)[:2]

    def rows(x):  # this rank's rows of a (N, ...) tensor, whole along the rest
        return x.full_tensor()[row0:row0 + n_loc] if is_dtensor(x) else x[row0:row0 + n_loc]

    # the new values placed as the slab's rows and heads, every lane
    lanes = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in slab.placements]
    vals = new.redistribute(slab.device_mesh, lanes).to_local()

    dest_l = rows(dest) - slot0
    ok = rows(lane_ok) & (dest_l >= 0) & (dest_l < t_loc)
    flat = local.view(n_loc * t_loc, *local.shape[2:])
    idx = (torch.arange(n_loc, device=local.device)[:, None] * t_loc
           + dest_l.clamp(0, t_loc - 1)).reshape(-1)
    keep = ok.reshape(-1, *([1] * (local.dim() - 2)))
    flat.index_copy_(0, idx, torch.where(keep, vals.reshape(-1, *local.shape[2:]).to(local.dtype),
                                         flat.index_select(0, idx)))


def attn_slab_decode(cfg: ModelConfig, p: dict, cache: dict, x, positions, live):
    """The slab decode tick: the reference's ``attn_decode_step`` at a
    position per slot.  x: (N, 1, D); positions: (N,) int32; live: (N,)
    bool (a parked slot writes nothing); cache: this layer's {"k", "v"}
    (N, T, KV, dh), written in place.  Returns (N, 1, D)."""
    q, k_new, v_new = _qkv(cfg, p, x, positions.long()[:, None])
    slots = cache["k"].shape[1]
    pos = positions.long()[:, None]
    slot = pos % slots if cfg.sliding_window else pos
    for name, new in (("k", k_new), ("v", v_new)):
        slab_write(cache[name], new, slot, live[:, None])
    return _attend_slab(cfg, p, q, cache["k"], cache["v"],
                        _ring_valid(cfg, slots, slot, pos)[:, None])


def attn_slab_chunk(cfg: ModelConfig, p: dict, cache: dict, x, positions, n_valid):
    """The slab fused tick: the reference's ``attn_decode_chunk`` per slot.
    x: (N, C, D); positions/n_valid: (N,) int32; lane i of slot s takes
    position positions[s] + i and writes it if i < n_valid[s]; cache: this
    layer's {"k", "v"} (N, T, KV, dh), written in place.  Full attention
    reads the slab after the writes, [0, position]; a sliding window reads
    the ring before them beside the chunk's own keys (a chunk's writes evict
    entries its earliest lanes still see): the ring entry of age a holds
    position (pos - 1) - a, visible to a row iff it exists and lies in the
    row's window.  Returns (N, C, D)."""
    n, c_len, _ = x.shape
    offs = torch.arange(c_len, device=x.device)
    pos = positions.long()[:, None]
    rows = pos + offs[None, :]
    q, k_new, v_new = _qkv(cfg, p, x, rows)
    slots = cache["k"].shape[1]
    win = cfg.sliding_window or 0
    if win:
        idx = torch.arange(slots, device=x.device)
        age_old = ((pos - 1) % slots - idx[None, :]) % slots  # 0 = the newest
        abs_old = ((pos - 1) - age_old)[:, None, :]  # (N, 1, slots)
        valid_old = (abs_old >= rows[:, :, None] - (win - 1)) & (abs_old >= 0)
        valid_new = (offs[None, :] <= offs[:, None]).expand(n, c_len, c_len)
        valid = torch.cat([valid_old, valid_new], dim=2)
        k_at = torch.cat([cache["k"], k_new.to(cache["k"].dtype)], dim=1)
        v_at = torch.cat([cache["v"], v_new.to(cache["v"].dtype)], dim=1)
    lane_ok = offs[None, :] < n_valid[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        slab_write(cache[name], new, rows % slots, lane_ok)
    if not win:
        valid = torch.arange(slots, device=x.device)[None, None, :] <= rows[:, :, None]
        k_at, v_at = cache["k"], cache["v"]
    return _attend_slab(cfg, p, q, k_at, v_at, valid)


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
    score or a live lane's output is nonfinite.  pmat: (N, KV, G, C, T);
    scores: the raw score product of the same shape, before the scale (for
    a positive finite scale that is < 1, a visible score is finite exactly
    when its scaled f32 value is, which the reference tests); out: (N, C,
    ...) before wo; valid: (N, C, T); lane_ok: (N, C).  Returns (N,) f32."""
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
    row is a convex mix of V rows, so its sum cannot overflow), and the
    kernel's (N, C, H) flags of rows that saw a nonfinite live score, which
    make the channel +inf on a live lane with either, else 0; [1] the share
    of the slot's int8 writes this tick that clipped; [2] 1.0 when a scale
    of the slot's live horizon is nonfinite, negative or past
    SCALE_SANITY_MAX (``scales``: the (L, nb + 1) k and v scales after the
    tick's writes, or None).  Parked lanes (n_valid = 0) read stale blocks
    by design: every channel is 0 there."""
    dev = positions.device
    n, layers = positions.shape[0], len(probes)
    zero = torch.zeros(layers, n, dtype=torch.float32, device=dev)
    active = (n_valid > 0)[None, :]
    if isinstance(probes[0][0], tuple):  # the kernel read's row sums and score flags
        sums = torch.stack([p[0] for p, _ in probes])  # (L, N, C)
        flags = torch.stack([p[1] for p, _ in probes]).amax(dim=3)  # (L, N, C)
        lane_ok = torch.arange(sums.shape[2], device=dev)[None, :] < n_valid[:, None]
        bad = ((~torch.isfinite(sums) | (flags > 0)) & lane_ok).any(dim=2)
        probe0 = torch.where(bad, torch.inf, 0.0)
    else:
        probe0 = torch.stack([p for p, _ in probes])
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
    the GN paged-attention kernel, for the GN softmax, ``"streamed"`` for
    the exact one and ``"gathered"`` for the one-pass-only names, as the
    reference.  The reference serves its Pallas kernel only under
    ``use_pallas``; the port has no such switch.  The kernel is GN-only."""
    _softmax(cfg)
    if FORCE_PAGED_READ is None:
        return {"gn": "kernel", "exact": "streamed"}.get(cfg.softmax_impl, "gathered")
    if FORCE_PAGED_READ not in READ_PATHS:
        raise ValueError(f"FORCE_PAGED_READ must be None or one of {READ_PATHS}, got "
                         f"{FORCE_PAGED_READ!r}")
    if FORCE_PAGED_READ == "kernel" and cfg.softmax_impl != "gn":
        raise NotImplementedError(f"the paged kernel read is GN-only, not "
                                  f"softmax_impl={cfg.softmax_impl!r}")
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
                      probe_nv=None, impl: str = "gn"):
    """The reference's streamed (``_stream_paged_tiles``) or gathered read.

    q: (N, C, H, dh) rotated, in the activation dtype; arenas (nb + 1, bs,
    KV, dh); tables: (N, H') int32; rows: (N, C) absolute positions; scales:
    (k_scale, v_scale) for int8 arenas, else None.  The streamed read
    gathers K ``STREAM_TILE`` table columns at a time and emits each tile's
    scores, which are the gathered read's dots column for column; both run
    the same softmax and the same P·V over the horizon's V blocks.  Returns
    (N, C, H * dh) in the value dtype; with ``probe_nv`` (the tick's n_valid)
    also the full Σp probe (``_probe_sum_residual``) of its scores and
    probabilities, as the reference's two reads return it.  ``impl``: the
    config's softmax name (``_score_softmax``)."""
    n, c_len, h, dh = q.shape
    kv = arena_k.shape[2]
    dt = q.dtype
    qg = q.reshape(n, c_len, kv, h // kv, dh)
    tables = tables.long()
    k_scale, v_scale = scales if scales is not None else (None, None)
    if streamed:
        scores = torch.cat([
            _score_product(qg, _gather_blocks(arena_k, k_scale, tbl, dt).reshape(n, -1, kv, dh))
            for tbl in tables.split(STREAM_TILE, dim=1)], dim=-1)
    else:
        k_at = _gather_blocks(arena_k, k_scale, tables, dt).reshape(n, -1, kv, dh)
        scores = _score_product(qg, k_at)
    valid = torch.arange(scores.shape[-1], device=q.device)[None, None, :] <= rows[:, :, None]
    v_at = _gather_blocks(arena_v, v_scale, tables, dt).reshape(n, -1, kv, dh)
    pmat = _score_softmax(impl, scores, dh ** -0.5, valid[:, None, None], v_at.dtype)
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
    streamed and gathered reads, or the kernel read's pair (its output's
    row sums (N, C) f32, its (N, C, H) flags of a nonfinite live score);
    clip the (N * C,) int8 writes that saturated, or None over fp arenas.
    """
    _softmax(cfg)  # an unknown softmax name raises before the arenas change
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
                                       scales=scales, nonfinite=probe)
        if probe:  # the probabilities stay in the kernel: its output and its flags
            out, flags = out
            probe0 = (out.reshape(b, c_len, -1).sum(dim=-1, dtype=torch.float32), flags)
    else:
        out = _paged_read_plain(q, arena_k, arena_v, tables, rows, scales,
                                streamed=path == "streamed", probe_nv=n_valid if probe else None,
                                impl=cfg.softmax_impl)
        if probe:
            out, probe0 = out
    out = out.reshape(b, c_len, cfg.q_features).to(x.dtype) @ p["wo"]
    if not probe:
        return out
    return out, (probe0, clips[0] | clips[1] if clips else None)
