"""Chunked (flash-style) attention with a streaming softmax (port of
``repro/models/chunked_attention.py``), in plain torch: the reference runs
it in jnp outside any Pallas kernel, so ``torch.matmul`` over the tiles is
its port, on the card too.  It never holds more than a (.., S_q, kv_chunk)
tile of scores.

The streamed softmax is the reference's:
  * the stabilizer is the running max snapped up to the Δ grid (GN), equal
    to the one-pass ``gn_softmax`` stabilizer once every chunk is seen;
  * every exponential, numerators and the rescales of earlier partial sums,
    goes through ``factorized_exp_ste`` (GN) or ``exp`` (exact);
  * one division by the accumulated sum of the numerators at the end, so
    Σp = 1 to one rounding however the row was chunked.

Scores are f32 products of the inputs (the reference's
``preferred_element_type=f32``), scaled after the dot; the numerators are
cast to v's dtype before P·V, accumulated in f32.

Causal attention takes the reference's hierarchy of halves: ``leaf``-sized
diagonal blocks with the causal mask, then at each level the high half of
every block attends its low half as an unmasked rectangle.  That
decomposition exists only where S / leaf is a power of two and every half
splits into whole kv chunks: past 2048 tokens at the defaults, only at
2048 * 2^k (the reference asserts elsewhere).  At any other length the port
computes the same function another way: q blocks of ``leaf`` rows, each
streaming the kv chunks up to its last row, the causal mask on the chunks
that cross the diagonal, and a shorter last chunk where the length is not
a multiple (``_stream_rect``'s tail).  Sliding-window attention is the
reference's banded q-chunk scan, a shorter last q chunk where the length
is not a multiple.

Shapes are (B, H, S, dh) with kv heads already broadcast to H; the
dispatcher ``chunked_self_attention`` takes the model's (B, S, H, dh)
layout and broadcasts GQA.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.gn_softmax import factorized_exp_ste
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.parallel.sharding import shard

NEG = -1e30


def _exp_pair(impl: str, lut_cfg: SoftmaxLUTConfig):
    """-> (exp_fn(delta >= 0) = e^-delta or its LUT value, grid step or None)."""
    if impl.startswith("gn"):
        return functools.partial(factorized_exp_ste, cfg=lut_cfg), lut_cfg.step
    return (lambda d: torch.exp(-d)), None


def _snap_up(m, step):
    return torch.ceil(m / step) * step if step else m


def _update(state, s, v_c, exp_fn, step, guard: bool = True):
    """Online-softmax accumulation of one score tile.  state: (acc (..., Sq,
    dv) f32, m (..., Sq) f32, z (..., Sq) f32); s: (..., Sq, Kc) f32 scores,
    masked entries at NEG; v_c: (..., Kc, dv).  ``guard=False`` skips the
    zeroing of masked numerators for tiles known to be fully valid."""
    acc, m, z = state
    m_c = _snap_up(s.amax(dim=-1), step)
    m_new = torch.maximum(m, m_c)
    resc = exp_fn((m_new - m).clamp_min(0.0))  # e^-(m_new - m), on the grid
    y = exp_fn((m_new[..., None] - s).clamp_min(0.0))
    if guard:
        y = torch.where(s <= NEG / 2, 0.0, y)
    z = z * resc + y.sum(dim=-1)
    pv = torch.matmul(y.to(v_c.dtype).float(), v_c.float())
    return acc * resc[..., None] + pv, m_new, z


def _init_state(lead, dv, device):
    """lead = q.shape[:-1] (..., Sq): the state's rows run parallel to q's."""
    return (torch.zeros(*lead, dv, dtype=torch.float32, device=device),
            torch.full(lead, NEG, dtype=torch.float32, device=device),
            torch.zeros(lead, dtype=torch.float32, device=device))


def _stream_rect(q, k, v, state, exp_fn, step, kv_chunk, scale, mask_fn=None, col0: int = 0):
    """q (..., Sq, dh) against the kv rectangle (..., T, dh) in chunks of
    ``kv_chunk`` (a shorter last one when T is not a multiple);
    ``mask_fn(c0, c1)`` -> a bool mask broadcastable to (..., Sq, c1 - c0)
    over columns [c0, c1) (offset by ``col0``), or None."""
    t = k.shape[-2]
    kc = min(kv_chunk, t)
    qf = q.float()
    for c0 in range(0, t, kc):
        c1 = min(c0 + kc, t)
        s = torch.matmul(qf, k[..., c0:c1, :].float().transpose(-1, -2)) * scale
        mask = None if mask_fn is None else mask_fn(col0 + c0, col0 + c1)
        if mask is not None:
            s = torch.where(mask, s, NEG)
        state = _update(state, s, v[..., c0:c1, :], exp_fn, step, guard=mask is not None)
    return state


def _finalize(state):
    acc, _, z = state
    return acc * (1.0 / z.clamp_min(1e-30))[..., None]


def _halves_fit(s: int, leaf: int, kv_chunk: int) -> bool:
    """Whether the reference's hierarchy of halves serves length ``s``:
    S / leaf a power of two, the leaf and every half whole kv chunks."""
    if leaf % min(kv_chunk, leaf):
        return False
    w = s
    if (s // leaf) & (s // leaf - 1):
        return False
    while w > leaf:
        w //= 2
        if w % min(kv_chunk, w):
            return False
    return True


# ---------------------------------------------------------------- causal ---
def causal_chunked(q, k, v, *, impl: str = "gn", lut_cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
                   kv_chunk: int = 1024, leaf: int = 2048, scale: Optional[float] = None):
    """Causal self-attention, (B, H, S, dh) -> (B, H, S, dv) f32 (the value
    head dim may differ, MLA): the reference's hierarchy of halves where it
    exists, q blocks streaming their causal kv prefix elsewhere."""
    b, h, s, dh = q.shape
    dv = v.shape[-1]
    scale = dh ** -0.5 if scale is None else scale
    exp_fn, step = _exp_pair(impl, lut_cfg)
    leaf = min(leaf, s)
    while s % leaf:
        leaf //= 2
    kc = min(kv_chunk, leaf)
    if not _halves_fit(s, leaf, kv_chunk):
        return _causal_blocks(q, k, v, exp_fn, step, kv_chunk, min(2048, s), scale)

    # diagonal leaves: (B, H, nl, leaf) blocks, the causal mask inside
    nl = s // leaf
    rows = torch.arange(leaf, device=q.device)[:, None]

    def leaf_mask(c0, c1):
        return torch.arange(c0, c1, device=q.device)[None, :] <= rows

    def blk(x):
        return x.reshape(b, h, nl, leaf, x.shape[-1])

    acc, m, z = _init_state((b, h, nl, leaf), dv, q.device)
    acc, m, z = _stream_rect(blk(q), blk(k), blk(v), (acc, m, z), exp_fn, step, kc, scale,
                             mask_fn=leaf_mask)
    acc, m, z = acc.reshape(b, h, s, dv), m.reshape(b, h, s), z.reshape(b, h, s)

    # off-diagonal levels: the high half of each block attends its low half
    w, nb = s, 1
    while w > leaf:
        w2 = w // 2
        qv = q.reshape(b, h, nb, 2, w2, dh)
        kv_ = k.reshape(b, h, nb, 2, w2, dh)
        vv = v.reshape(b, h, nb, 2, w2, dv)
        accv = acc.reshape(b, h, nb, 2, w2, dv)
        mv, zv = m.reshape(b, h, nb, 2, w2), z.reshape(b, h, nb, 2, w2)
        hi = _stream_rect(qv[:, :, :, 1], kv_[:, :, :, 0], vv[:, :, :, 0],
                          (accv[:, :, :, 1], mv[:, :, :, 1], zv[:, :, :, 1]),
                          exp_fn, step, min(kv_chunk, w2), scale)
        acc = torch.stack([accv[:, :, :, 0], hi[0]], dim=3).reshape(b, h, s, dv)
        m = torch.stack([mv[:, :, :, 0], hi[1]], dim=3).reshape(b, h, s)
        z = torch.stack([zv[:, :, :, 0], hi[2]], dim=3).reshape(b, h, s)
        nb *= 2
        w = w2
    return _finalize((acc, m, z))


def _causal_blocks(q, k, v, exp_fn, step, kv_chunk, rows, scale):
    """Causal attention at a length the hierarchy of halves does not serve:
    q blocks of ``rows`` rows, each streaming kv [0, its last row] in
    chunks, masked where a chunk crosses the diagonal."""
    s = q.shape[2]
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(r0 + rows, s)
        row_ix = torch.arange(r0, r1, device=q.device)[:, None]

        def mask_fn(c0, c1, row_ix=row_ix, r0=r0):
            if c1 <= r0 + 1:  # every column at or before the block's first row
                return None
            return torch.arange(c0, c1, device=q.device)[None, :] <= row_ix

        st = _init_state(q[:, :, r0:r1].shape[:-1], v.shape[-1], q.device)
        st = _stream_rect(q[:, :, r0:r1], k[:, :, :r1], v[:, :, :r1], st, exp_fn, step,
                          kv_chunk, scale, mask_fn=mask_fn)
        outs.append(_finalize(st))
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------- window ---
def windowed_chunked(q, k, v, *, window: int, impl: str = "gn",
                     lut_cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT, q_chunk: int = 1024,
                     scale: Optional[float] = None):
    """Causal sliding-window attention by the reference's banded q-chunk
    scan: each q chunk sees a (window + chunk)-wide kv slice of the
    front-padded sequence, in one ``_update``.  Returns (B, H, S, dh) f32."""
    b, h, s, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    exp_fn, step = _exp_pair(impl, lut_cfg)
    qc = min(q_chunk, s)
    pad = torch.zeros(b, h, window, dh, dtype=k.dtype, device=k.device)
    kp, vp = torch.cat([pad, k], dim=2), torch.cat([pad, v], dim=2)
    outs = []
    for start in range(0, s, qc):
        n = min(qc, s - start)
        band = window + n
        k_c, v_c = kp[:, :, start:start + band], vp[:, :, start:start + band]
        srow = torch.matmul(q[:, :, start:start + n].float(), k_c.float().transpose(-1, -2))
        srow = srow * scale
        qi = torch.arange(n, device=q.device)[:, None]
        col = torch.arange(band, device=q.device)[None, :] - window
        valid = (col <= qi) & (col > qi - window) & (start + col >= 0)
        srow = torch.where(valid, srow, NEG)
        st = _update(_init_state((b, h, n), dh, q.device), srow, v_c, exp_fn, step)
        outs.append(_finalize(st))
    return torch.cat(outs, dim=2)


# ------------------------------------------------------------- dispatcher ---
def chunked_self_attention(cfg, q, k, v, causal: bool,
                           lut_cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT):
    """(B, S, H, dh) q and (B, T, KV, dh) k, v -> (B, S, H, dh) in q's dtype:
    GQA broadcast, the (B, H, S, dh) layout, and the reference's choice of
    the windowed scan, the causal hierarchy or the plain kv stream."""
    s, hq, dh = q.shape[1:]
    group = hq // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qt, kt, vt = (shard(x.transpose(1, 2), "batch", "heads_act", None, None)
                  for x in (q, k, v))
    impl = cfg.softmax_impl
    if causal and cfg.sliding_window and s > cfg.sliding_window:
        out = windowed_chunked(qt, kt, vt, window=cfg.sliding_window, impl=impl, lut_cfg=lut_cfg)
    elif causal:
        out = causal_chunked(qt, kt, vt, impl=impl, lut_cfg=lut_cfg)
    else:
        st = _init_state(qt.shape[:-1], dh, q.device)
        st = _stream_rect(qt, kt, vt, st, *_exp_pair(impl, lut_cfg), 1024, dh ** -0.5)
        out = _finalize(st)
    return out.to(q.dtype).transpose(1, 2)
