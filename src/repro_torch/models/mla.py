"""Multi-head Latent Attention, MiniCPM3 / DeepSeek-V2 style (port of
``repro/models/mla.py``).

Q and KV go through low-rank latents; a cache holds only the normalized kv
latent ``c_kv`` (kv_lora_rank a token) and the shared rotated rope key
``k_rope`` (qk_rope_head_dim a token), and every read expands the latent
through ``wkv_b`` into per-head no-rope keys and values.  Both latents' GN
RMSNorms go through the GN norm kernel's wrapper, as every GN norm of the
port does (the plain version on the CPU).  The softmax is
``cfg.softmax_impl`` over f32 score rows, as in ``attention.py``.  The
score is the reference's decomposition q_nope·k_nope + q_rope·k_rope, in
the activation dtype, scaled by (nope + rope)^-0.5 rounded to that dtype,
then cast to f32 and masked; for ``"gn"`` the scale, the cast, the mask,
the softmax and the cast to v's dtype are one launch of the fused GN
softmax kernel (``attention._score_softmax``).

Contiguous paths: ``mla_self_attention`` (the forward) and ``mla_prefill``
run one pass over the (S, S) scores up to ``CHUNKED_FROM`` (2048) tokens.
Past it the reference streams ``causal_chunked`` over q' = [q_nope | q_rope]
and k' = [k_nope | k_rope broadcast to every head] (the score decomposition
folds into one head dim of nope + rope) and v of head dim v_head_dim, scaled
by (nope + rope)^-0.5 as a float (``_attend_chunked``).  The port does the
same: GN through the flash kernel, whose k and v share one head dim, so v
is zero-padded to nope + rope and the output sliced back (the zero columns
add nothing to P·V), and the exact softmax through the port's plain
``causal_chunked``.  ``mla_decode_step`` writes the latent
slabs in place and reads them whole; ``mla_slab_chunk`` is the slab tick's
(the reference's ``mla_decode_chunk``, batched over the slots).

Paged path: the latent arenas (nb + 1, bs, rank) and (nb + 1, bs, rope),
the last block the write sink (``attention.paged_write_indices``), fp or
int8 with per-block scales written through ``attention.paged_quant_write``,
all in place.  There is no MLA kernel in the reference (the latent
expansion keeps the hot loop a matmul).  Its two reads, the streamed one
(a block at a time) and the gathered oracle, compute the same bits, so the
port reads through one body: each arena gathered once over the horizon's
table columns, expanded once, one softmax and one P·V.  The read path's
name is still the reference's (``mla_paged_read_path``: ``"streamed"`` by
default, ``"gathered"`` when ``attention.FORCE_PAGED_READ`` asks for it); a
forced ``"kernel"`` falls through to the default, as the reference's
forced ``"pallas"`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.attention import CHUNKED_FROM, causal_mask
from repro_torch.models.chunked_attention import causal_chunked
from repro_torch.models.layers import ParamSpec, gn_rmsnorm
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import shard

def mla_specs(cfg: ModelConfig) -> dict:
    d, m, h = cfg.d_model, cfg.mla, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamSpec((d, m.q_lora_rank), ("embed_fsdp", None)),
        "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="ones"),
        "wq_b": ParamSpec((m.q_lora_rank, h * qk_head), (None, "heads_tp")),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed_fsdp", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "wkv_b": ParamSpec((m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
                           (None, "heads_tp")),
        "wo": ParamSpec((h * m.v_head_dim, d), ("heads_tp", "embed_fsdp")),
    }


def _project(cfg: ModelConfig, p: dict, x, positions):
    """x (B, S, D), positions (B, S) -> q_nope (B, S, H, nope), q_rope
    (B, S, H, rope) rotated, c_kv (B, S, rank) normalized, k_rope (B, S,
    rope) rotated; p holds x's dtype (the gammas f32)."""
    m = cfg.mla
    b, s, _ = x.shape
    q_lat = gn_rmsnorm(x @ p["wq_a"], p["q_norm"])
    q = (q_lat @ p["wq_b"]).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]
    c_kv = gn_rmsnorm(kv_a[..., :m.kv_lora_rank].contiguous(), p["kv_norm"])
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _expand(cfg: ModelConfig, p: dict, c_kv):
    """c_kv (B, T, rank) -> k_nope (B, T, H, nope), v (B, T, H, v_head)."""
    m = cfg.mla
    b, t, _ = c_kv.shape
    kv = (c_kv @ p["wkv_b"]).reshape(b, t, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def _scores(q_nope, q_rope, k_nope, k_rope):
    """(B, H, S, T) raw scores q_nope·k_nope + q_rope·k_rope in the
    activation dtype, before the scale (``_softmax_av`` applies it)."""
    return (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
            + torch.einsum("bshd,btd->bhst", q_rope, k_rope))


def _softmax_av(cfg: ModelConfig, scores, v, mask, probe_lanes=None):
    """Scale the raw scores by (nope + rope)^-0.5 (rounded to their dtype,
    as jnp rounds a Python float), cast them to f32, mask, softmax them
    (``attention._score_softmax``: one fused kernel launch for GN), weight
    v (B, T, H, dv): the attention (B, S, H, dv) in v's dtype; with
    ``probe_lanes`` ((B, S) live lanes) also the Σp probe (B,) of
    ``attention._probe_sum_residual`` over the raw scores."""
    m = cfg.mla
    pmat = attn._score_softmax(cfg.softmax_impl, scores,
                               (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5, mask, v.dtype)
    att = torch.einsum("bhst,bthd->bshd", pmat, v)
    if probe_lanes is None:
        return att
    b, _, s, t = scores.shape
    valid = mask.expand(b, 1, s, t)[:, 0]
    return att, attn._probe_sum_residual(pmat[:, :, None], scores[:, :, None], att, valid,
                                         probe_lanes)


def _attend(cfg: ModelConfig, p: dict, q_nope, q_rope, c_kv, k_rope, mask, probe_lanes=None):
    """Attention against the expanded latent, projected by wo: (B, S, D)
    (and the probe, with ``probe_lanes``).  c_kv (B, T, rank), k_rope (B, T,
    rope), mask broadcastable to (B, 1, S, T)."""
    b, s = q_nope.shape[:2]
    k_nope, v = _expand(cfg, p, c_kv)
    att = _softmax_av(cfg, _scores(q_nope, q_rope, k_nope, k_rope), v, mask, probe_lanes)
    probe = None
    if probe_lanes is not None:
        att, probe = att
    out = att.reshape(b, s, cfg.n_heads * cfg.mla.v_head_dim) @ p["wo"]
    return out if probe is None else (out, probe)


def _use_chunked(cfg: ModelConfig, s: int) -> bool:
    return s > CHUNKED_FROM and cfg.softmax_impl in ("gn", "exact")


def _attend_chunked(cfg: ModelConfig, p: dict, q_nope, q_rope, c_kv, k_rope):
    """Causal attention past ``CHUNKED_FROM`` over the expanded latent (the
    reference's ``_attend_chunked``; see the module docstring), projected
    by wo: (B, S, D)."""
    m, h = cfg.mla, cfg.n_heads
    b, s = q_nope.shape[:2]
    k_nope, v = _expand(cfg, p, c_kv)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    heads = ("batch", "heads_act", None, None)
    qq = shard(torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2), *heads)
    kk = shard(torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, k_rope.shape[-1])],
                         dim=-1).transpose(1, 2), *heads)
    vt = shard(v.transpose(1, 2), *heads)
    if cfg.softmax_impl == "gn":
        pad = qq.shape[-1] - m.v_head_dim
        vp = torch.nn.functional.pad(vt, (0, pad))
        out = attn.local_flash(qq.contiguous(), kk.contiguous(), vp.contiguous(), True,
                               sm_scale=scale)[..., :m.v_head_dim]
    else:
        out = causal_chunked(qq, kk, vt, impl=cfg.softmax_impl, scale=scale).to(q_nope.dtype)
    return out.transpose(1, 2).reshape(b, s, h * m.v_head_dim) @ p["wo"]


def mla_self_attention(cfg: ModelConfig, p: dict, x, positions, causal: bool = True):
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _project(cfg, p, x, positions)
    if causal and _use_chunked(cfg, s):
        return _attend_chunked(cfg, p, q_nope, q_rope, c_kv, k_rope)
    mask = (causal_mask(s, s, x.device) if causal
            else torch.ones(1, 1, s, s, dtype=torch.bool, device=x.device))
    return _attend(cfg, p, q_nope, q_rope, c_kv, k_rope, mask)


def mla_cache_shape(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """One layer's latent slabs, name -> (shape, dtype)."""
    m, dt = cfg.mla, getattr(torch, cfg.dtype)
    return {"c_kv": ((batch, max_seq, m.kv_lora_rank), dt),
            "k_rope": ((batch, max_seq, m.qk_rope_head_dim), dt)}


def mla_prefill(cfg: ModelConfig, p: dict, x, positions):
    """(out (B, S, D), {"c_kv" (B, S, rank), "k_rope" (B, S, rope)})."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _project(cfg, p, x, positions)
    if _use_chunked(cfg, s):
        out = _attend_chunked(cfg, p, q_nope, q_rope, c_kv, k_rope)
    else:
        out = _attend(cfg, p, q_nope, q_rope, c_kv, k_rope, causal_mask(s, s, x.device))
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode_step(cfg: ModelConfig, p: dict, cache: dict, x, pos):
    """One-token decode over this layer's latent slabs (B, T, ...), slot
    ``pos`` (a 0-d int32 tensor on x's device) written in place: the slab
    tick with every row at ``pos``."""
    b = x.shape[0]
    ones = torch.ones(b, dtype=torch.int32, device=x.device)
    return mla_slab_chunk(cfg, p, cache, x, pos.reshape(1).expand(b), ones), cache


def mla_slab_chunk(cfg: ModelConfig, p: dict, cache: dict, x, positions, n_valid):
    """The slab tick over the latent slabs: the reference's
    ``mla_decode_chunk`` per slot (its decode step at C = 1).  x: (N, C, D);
    positions/n_valid: (N,) int32, lane i of slot s at position
    positions[s] + i, written if i < n_valid[s]; cache: this layer's
    {"c_kv", "k_rope"} (N, T, width), written in place, then read over
    [0, position].  Returns (N, C, D)."""
    c_len = x.shape[1]
    offs = torch.arange(c_len, device=x.device)
    rows = positions.long()[:, None] + offs[None, :]
    q_nope, q_rope, c_new, kr_new = _project(cfg, p, x, rows)
    t = cache["c_kv"].shape[1]
    lane_ok = offs[None, :] < n_valid[:, None]
    for name, new in (("c_kv", c_new), ("k_rope", kr_new)):
        attn.slab_write(cache[name], new, rows % t, lane_ok)
    valid = (torch.arange(t, device=x.device)[None, None, :] <= rows[:, :, None])[:, None]
    return _attend(cfg, p, q_nope, q_rope, cache["c_kv"], cache["k_rope"], valid)


# ------------------------------------------------------------ paged tick --
def mla_paged_read_path(cfg: ModelConfig) -> str:
    """``"streamed"`` or ``"gathered"`` when ``FORCE_PAGED_READ`` names one,
    else the reference's auto choice: streamed for the GN and the exact
    softmax, gathered for the one-pass-only names.  A forced ``"kernel"``
    falls through to the auto choice: there is no MLA kernel."""
    attn._softmax(cfg)
    if attn.FORCE_PAGED_READ in ("streamed", "gathered"):
        return attn.FORCE_PAGED_READ
    if attn.FORCE_PAGED_READ not in (None, "kernel"):
        raise ValueError(f"FORCE_PAGED_READ must be None or one of {attn.READ_PATHS}, got "
                         f"{attn.FORCE_PAGED_READ!r}")
    return "streamed" if cfg.softmax_impl in ("gn", "exact") else "gathered"


def _gather_latent(arena, scale, tables, dt):
    """arena[tables] (N, H', bs, w) -> (N, H' * bs, w) in ``dt``; int8
    blocks dequantized after the gather by their scale cast to ``dt``."""
    blocks = arena[tables].to(dt)
    if scale is not None:
        blocks = blocks * scale[tables].to(dt)[..., None, None]
    return blocks.reshape(blocks.shape[0], -1, blocks.shape[-1])


def _paged_read(cfg: ModelConfig, p: dict, q_nope, q_rope, arena_ckv, arena_krope, tables,
                rows, scales, probe_nv=None):
    """The reference's streamed (``_mla_stream_tiles``) and gathered reads,
    which it holds bitwise equal, as one body: (N, C, H * dv) in the
    activation dtype, and with ``probe_nv`` (the tick's n_valid) the Σp
    probe (N,).  Each slot's latent stream is gathered over the horizon's
    table columns and expanded once; one softmax over its columns and one
    P·V over the expanded values in logical column order."""
    dt = q_nope.dtype
    n, c_len = rows.shape
    tables = tables.long()
    c_scale, r_scale = scales if scales is not None else (None, None)
    k_nope, v = _expand(cfg, p, _gather_latent(arena_ckv, c_scale, tables, dt))
    scores = _scores(q_nope, q_rope, k_nope, _gather_latent(arena_krope, r_scale, tables, dt))
    valid = (torch.arange(scores.shape[-1], device=rows.device)[None, None, :]
             <= rows[:, :, None])[:, None]
    lanes = None
    if probe_nv is not None:
        lanes = torch.arange(c_len, device=rows.device)[None, :] < probe_nv[:, None]
    att = _softmax_av(cfg, scores, v, valid, lanes)
    if probe_nv is None:
        return att.reshape(n, c_len, -1)
    return att[0].reshape(n, c_len, -1), att[1]


def mla_paged_chunk(cfg: ModelConfig, p: dict, arena_ckv, arena_krope, x, positions,
                    n_valid, tables, scales=None, probe: bool = False):
    """Block-paged chunked append over the latent arenas, batched over
    slots (the contract of ``attention.attn_paged_chunk``).  x: (N, C, D);
    positions/n_valid: (N,) int32; tables: (N, max_bt) int32; arena_ckv
    (nb + 1, bs, rank) and arena_krope (nb + 1, bs, rope), written in place;
    ``scales`` = (c_kv_scale, k_rope_scale), each (nb + 1,) f32 and written
    in place, marks them int8.  Returns (N, C, D); with ``probe`` also the
    layer's probe (the read's Σp probe (N,), the (N * C,) int8 writes that
    saturated or None), as ``attn_paged_chunk`` returns it for
    ``attention.paged_probe_word``."""
    b, c_len, _ = x.shape
    nb, bs = arena_ckv.shape[0] - 1, arena_ckv.shape[1]
    rows = positions.long()[:, None] + torch.arange(c_len, device=x.device)[None, :]
    q_nope, q_rope, c_new, kr_new = _project(cfg, p, x, rows)

    dest = attn.paged_write_indices(rows, n_valid, tables, bs, nb)
    clips = []
    for arena, new, scale in zip((arena_ckv, arena_krope), (c_new, kr_new),
                                 scales or (None, None)):
        flat, vals = arena.view(-1, arena.shape[-1]), new.reshape(-1, arena.shape[-1])
        if scale is None:
            flat.index_copy_(0, dest, vals.to(arena.dtype))
        else:
            clips.append(attn.paged_quant_write(flat, scale, vals, dest, bs, return_clip=probe))

    mla_paged_read_path(cfg)  # refuses an unknown forced read
    out = _paged_read(cfg, p, q_nope, q_rope, arena_ckv, arena_krope, tables, rows, scales,
                      probe_nv=n_valid if probe else None)
    if probe:
        out, probe0 = out
    out = out @ p["wo"]
    if not probe:
        return out
    return out, (probe0, clips[0] | clips[1] if clips else None)
