"""Sequence-state mixers (port of ``repro/models/ssm.py``): mLSTM (xLSTM)
and Mamba2 (SSD), each in its recurrent (state-passing) form and its chunked
form.

The reference runs these in jnp outside any Pallas kernel, so they are
plain PyTorch here: the per-token recurrence a Python loop over the time
steps (``jax.lax.scan`` there), the chunked forms a loop over chunks.  The
paper's technique reaches these blocks through their norms: the mixers' own
gated RMS norms go through the GN norm kernel on the card
(``layers.gn_rmsnorm``), the plain version on the CPU.

Carries, as the reference's cache tuples: mLSTM (conv state (B, K-1, d_in)
in the activation dtype, C (B, H, dh, dh), n (B, H, dh), m (B, H) f32);
Mamba2 (conv state (B, K-1, d_in + 2N) in the activation dtype, h (B, H,
dh, N) f32).  ``n_valid`` is a (B,) int tensor here (the reference traces a
scalar per vmapped row): row b's steps >= n_valid[b] leave its carries where
they were, so the batched slab tick runs every slot at its own length, and
n_valid = 0 parks a row.

Parameters arrive as ``Model.prepare`` leaves them: the projections,
``conv_w`` and ``b_gate`` in the activation dtype (the reference's
``.astype(dt)`` at each use), ``a_log``, ``dt_bias``, ``d_skip`` and the
Mamba2 ``norm`` f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, gn_rmsnorm

# On exact (serving) calls, below this length the K-tap shift-add form is
# used instead of the fused grouped conv: the two differ in accumulation
# order (the conv accumulates in f32, the chain rounds each tap in the
# activation dtype), so every serving path (monolithic prefill, chunked
# prefill, decode) lands on the same side and stays bit-identical to the
# static oracle.  The reference's threshold, kept as it is.
_CONV_FUSED_MIN = 256


def _chunked(chunk: int, s: int, n_valid) -> bool:
    """The reference's gate of the chunked forms: training and static
    prefills whose length is a multiple of the chunk, never a serving call
    with ``n_valid``."""
    return bool(chunk) and s > chunk and s % chunk == 0 and n_valid is None


# =============================================================== mLSTM ======
def mlstm_specs(cfg: ModelConfig) -> dict:
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    dh = d // cfg.n_heads * s.expand
    return {
        "w_up": ParamSpec((d, 2 * d_in), ("embed_fsdp", "ff")),
        "conv_w": ParamSpec((s.conv_dim, d_in), (None, "ff")),
        # block-diagonal per-head projections (the xLSTM paper)
        "wq": ParamSpec((cfg.n_heads, dh, dh), (None, "heads_tp", None)),
        "wk": ParamSpec((cfg.n_heads, dh, dh), (None, "heads_tp", None)),
        "wv": ParamSpec((cfg.n_heads, dh, dh), (None, "heads_tp", None)),
        "w_gate": ParamSpec((d_in, 2 * cfg.n_heads), ("ff", None)),
        "b_gate": ParamSpec((2 * cfg.n_heads,), (None,), init="zeros"),
        "w_down": ParamSpec((d_in, d), ("ff", "embed_fsdp")),
    }


def _causal_conv(x, w, state=None, n_valid=None, exact: bool = False):
    """Depthwise causal conv along time.  x: (B, S, C), w: (K, C) in x's
    dtype; ``state`` (B, K-1, C) the left context (None: zeros).  Returns
    (out (B, S, C), new state): the K-1 inputs ending at step S - 1, or with
    ``n_valid`` (B,) at step n_valid[b] - 1 of each row (a per-row gather),
    so a partly valid chunk hands the next one the context a contiguous
    pass would.  Long sequences (S >= K, or on ``exact`` calls S >=
    ``_CONV_FUSED_MIN``) take one grouped conv (``F.conv1d`` is a
    cross-correlation, as XLA's ``conv_general_dilated``); shorter ones the
    K-tap shift-add chain, each tap rounded in x's dtype in the reference's
    order."""
    b, s, c = x.shape
    k = w.shape[0]
    pad = (torch.zeros(b, k - 1, c, dtype=x.dtype, device=x.device) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    if s >= (max(k, _CONV_FUSED_MIN) if exact else k):
        out = F.conv1d(xp.transpose(1, 2), w.t()[:, None, :], groups=c).transpose(1, 2)
    else:
        out = torch.zeros_like(x)
        for i in range(k):
            out = out + xp[:, i:i + s] * w[i]
    if k <= 1:
        new_state = xp[:, :0]
    elif n_valid is None:
        new_state = xp[:, -(k - 1):]
    else:
        idx = n_valid.long()[:, None] + torch.arange(k - 1, device=x.device)[None, :]
        new_state = xp.gather(1, idx[..., None].expand(b, k - 1, c))
    return out, new_state


def _mlstm_heads(q, k, v, i_raw, f_raw, carry):
    """One time step of the mLSTM cell (stabilized exponential gating).
    q/k/v: (B, H, dh) f32; i_raw/f_raw: (B, H); carry = (C, n, m)."""
    C, n, m = carry
    dh = q.shape[-1]
    m_new = torch.maximum(f_raw + m, i_raw)
    i_g = torch.exp(i_raw - m_new)
    f_g = torch.exp(f_raw + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :] * (dh ** -0.5))
    n = f_g[..., None] * n + i_g[..., None] * k * (dh ** -0.5)
    h_num = torch.einsum("bhij,bhj->bhi", C, q)
    h_den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q).abs(), torch.exp(-m_new))
    return (C, n, m_new), h_num / h_den[..., None]


def _freeze(new: tuple, old: tuple, keep) -> tuple:
    """``new`` where ``keep`` (B,) holds, else ``old``, leaf by leaf."""
    return tuple(torch.where(keep.reshape(-1, *([1] * (a.dim() - 1))), a, o)
                 for a, o in zip(new, old))


def _mlstm_chunked(q, k, v, i_raw, f_raw, carry, chunk: int):
    """The chunkwise-parallel mLSTM (the reference's ``_mlstm_chunked``):
    with F the within-chunk inclusive cumsum of log-forget, s_j = i_j - F_j
    and the running stabilizer M_t = max(m_in, cummax_j s_j), masked
    intra-chunk products plus one (C, n, m) pass a chunk.  q/k/v: (B, S, H,
    dh) f32; i_raw/f_raw: (B, S, H) f32 (f_raw a log-sigmoid).  Returns (h
    (B, S, H*dh) f32, (C, n, m))."""
    b, s, H, dh = q.shape
    nc, Q = s // chunk, chunk
    qc = q.reshape(b, nc, Q, H, dh)
    kc = k.reshape(b, nc, Q, H, dh) * dh ** -0.5
    vc = v.reshape(b, nc, Q, H, dh)
    F_ = torch.cumsum(f_raw.reshape(b, nc, Q, H), dim=2)  # inclusive
    s_j = i_raw.reshape(b, nc, Q, H) - F_
    s_cummax = torch.cummax(s_j, dim=2).values
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=q.device))
    C_in, n_in, m_in = carry
    hs = []
    for c in range(nc):
        q_c, k_c, v_c, sj_c, F_c = qc[:, c], kc[:, c], vc[:, c], s_j[:, c], F_[:, c]
        M = torch.maximum(m_in[:, None], s_cummax[:, c])  # (b, Q, H)
        D = torch.exp(torch.where(tri[None, :, :, None],
                                  sj_c[:, None, :, :] - M[:, :, None, :], -torch.inf))
        G = torch.einsum("bthd,bjhd->bthj", q_c, k_c)
        num = torch.einsum("bthj,btjh,bjhd->bthd", G, D, v_c)
        n_t = torch.einsum("btjh,bjhd->bthd", D, k_c)
        carry_w = torch.exp(m_in[:, None] - M)
        num = num + carry_w[..., None] * torch.einsum("bhij,bthj->bthi", C_in, q_c)
        n_t = n_t + carry_w[..., None] * n_in[:, None]
        m_t = F_c + M
        qn = torch.einsum("bthd,bthd->bth", n_t, q_c).abs()
        hs.append(num / torch.maximum(qn, torch.exp(-m_t))[..., None])
        # the state to the next chunk (its stabilizer the last row's M)
        M_out = torch.maximum(m_in, s_cummax[:, c, -1])
        w_j = torch.exp(sj_c - M_out[:, None])
        cw = torch.exp(m_in - M_out)
        C_in = cw[..., None, None] * C_in + torch.einsum("bjh,bjhd,bjhe->bhde", w_j, v_c, k_c)
        n_in = cw[..., None] * n_in + torch.einsum("bjh,bjhd->bhd", w_j, k_c)
        m_in = F_c[:, -1] + M_out
    return torch.stack(hs, dim=1).reshape(b, s, H * dh), (C_in, n_in, m_in)


def mlstm_block(cfg: ModelConfig, p: dict, x, carry=None, n_valid=None, exact: bool = False):
    """x: (B, S, D) -> (y, carry); carry None starts from zeros and the
    stabilizer at -1e30.  ``n_valid`` (B,) freezes row b's carry after its
    first n_valid[b] steps; ``exact`` marks a serving call (the monolithic
    prefill), as a carry or ``n_valid`` do, so the conv takes the serving
    side of ``_CONV_FUSED_MIN``."""
    dt = x.dtype
    b, s, d = x.shape
    d_in = cfg.ssm.expand * d
    H = cfg.n_heads
    dh = d_in // H
    up = x @ p["w_up"]
    u, z = up[..., :d_in], up[..., d_in:]
    if carry is None:
        conv_state = None
        C0 = torch.zeros(b, H, dh, dh, dtype=torch.float32, device=x.device)
        n0 = torch.zeros(b, H, dh, dtype=torch.float32, device=x.device)
        m0 = torch.full((b, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        conv_state, C0, n0, m0 = carry
    exact = exact or carry is not None or n_valid is not None
    uc, conv_state = _causal_conv(u, p["conv_w"], conv_state, n_valid, exact)
    uc = F.silu(uc)
    uch, uh = uc.reshape(b, s, H, dh), u.reshape(b, s, H, dh)
    q = torch.einsum("bshd,hde->bshe", uch, p["wq"])
    k = torch.einsum("bshd,hde->bshe", uch, p["wk"])
    v = torch.einsum("bshd,hde->bshe", uh, p["wv"])
    gates = uc @ p["w_gate"] + p["b_gate"]
    i_raw = gates[..., :H].float()
    f_raw = F.logsigmoid(gates[..., H:].float())
    if _chunked(cfg.ssm.chunk, s, n_valid):
        h, (C, n, m) = _mlstm_chunked(q.float(), k.float(), v.float(), i_raw, f_raw,
                                      (C0, n0, m0), cfg.ssm.chunk)
        h = h.to(dt)
    else:
        state, hs = (C0, n0, m0), []
        for t in range(s):
            new, ht = _mlstm_heads(q[:, t].float(), k[:, t].float(), v[:, t].float(),
                                   i_raw[:, t], f_raw[:, t], state)
            state = new if n_valid is None else _freeze(new, state, t < n_valid)
            hs.append(ht)
        C, n, m = state
        h = torch.stack(hs, dim=1).reshape(b, s, d_in).to(dt)
    h = gn_rmsnorm(h)  # the block's normalizer (CoRN unit), no gamma
    y = (h * F.silu(z)) @ p["w_down"]
    return y, (conv_state, C, n, m)


def mlstm_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    """One layer's mLSTM carries, name -> (shape, dtype): the reference's
    cache tuple (conv, C, n, m)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = cfg.n_heads
    dh = d_in // h
    f32 = torch.float32
    return {"conv": ((batch, s.conv_dim - 1, d_in), getattr(torch, cfg.dtype)),
            "C": ((batch, h, dh, dh), f32), "n": ((batch, h, dh), f32), "m": ((batch, h), f32)}


# ============================================================== Mamba2 ======
def _ssd_recurrent(xs, B, C, dt_v, decay, h0, n_valid=None):
    """SSD in its per-token recurrent form.  xs: (B, S, H, dh); B/C: (B, S,
    N); dt_v/decay: (B, S, H) f32; h0: (B, H, dh, N) f32.  Returns (y (B, S,
    H, dh) f32, h_final); with ``n_valid`` (B,) row b's state freezes after
    its first n_valid[b] steps."""
    xs, B, C = xs.float(), B.float(), C.float()
    h, ys = h0, []
    for t in range(xs.shape[1]):
        h_new = h * decay[:, t, :, None, None] + (
            dt_v[:, t, :, None, None] * xs[:, t, ..., None] * B[:, t, None, None, :])
        ys.append(torch.einsum("bhdn,bn->bhd", h_new, C[:, t]))
        h = h_new if n_valid is None else _freeze((h_new,), (h,), t < n_valid)[0]
    return torch.stack(ys, dim=1), h


def _ssd_chunked(xs, B, C, dt_v, decay, h0, chunk: int):
    """SSD in its chunked (block) form (the reference's ``_ssd_chunked``):
    within a chunk of Q tokens the output is an attention-like pair of
    products, the state crosses chunk boundaries once a chunk.

      y_t   = sum_{j<=t} exp(l_t - l_j) dt_j (C_t . B_j) x_j + exp(l_t) C_t . h_in
      h_out = exp(l_last) h_in + sum_j exp(l_last - l_j) dt_j x_j B_j^T

    with l the inclusive cumsum of log decay within the chunk."""
    b, s, H, dh = xs.shape
    n = B.shape[-1]
    nc, Q = s // chunk, chunk
    xs = xs.reshape(b, nc, Q, H, dh).float()
    Bc = B.reshape(b, nc, Q, n).float()
    Cc = C.reshape(b, nc, Q, n).float()
    dt_c = dt_v.reshape(b, nc, Q, H)
    l = torch.cumsum(torch.log(torch.clamp_min(decay.reshape(b, nc, Q, H), 1e-38)), dim=2)
    l_last = l[:, :, -1]
    g = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))
    ldiff = torch.where(mask[None, None, :, :, None],
                        l[:, :, :, None, :] - l[:, :, None, :, :], -torch.inf)
    w = torch.exp(ldiff) * dt_c[:, :, None, :, :]
    y_intra = torch.einsum("bcij,bcijh,bcjhd->bcihd", g, w, xs)
    wj = torch.exp(l_last[:, :, None] - l) * dt_c
    s_c = torch.einsum("bcqh,bcqhd,bcqn->bchdn", wj, xs, Bc)
    g_last = torch.exp(l_last)
    c_e = Cc[:, :, :, None, :] * torch.exp(l)[..., None]
    h, y_inter = h0, []
    for c in range(nc):
        y_inter.append(torch.einsum("bhdn,bqhn->bqhd", h, c_e[:, c]))
        h = h * g_last[:, c, :, None, None] + s_c[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, H, dh), h


def mamba2_specs(cfg: ModelConfig) -> dict:
    d, s = cfg.d_model, cfg.ssm
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    return {
        "in_proj": ParamSpec((d, 2 * d_in + 2 * s.state_dim + nheads), ("embed_fsdp", "ff")),
        "conv_w": ParamSpec((s.conv_dim, d_in + 2 * s.state_dim), (None, None)),
        "a_log": ParamSpec((nheads,), (None,), init="zeros"),
        "d_skip": ParamSpec((nheads,), (None,), init="ones"),
        "dt_bias": ParamSpec((nheads,), (None,), init="zeros"),
        "norm": ParamSpec((d_in,), (None,), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("ff", "embed_fsdp")),
    }


def mamba2_block(cfg: ModelConfig, p: dict, x, carry=None, n_valid=None, exact: bool = False):
    """SSD.  x: (B, S, D) -> (y, (conv state, h)); ``n_valid`` and
    ``exact`` as in ``mlstm_block``."""
    dt_ = x.dtype
    b, s, d = x.shape
    d_in = cfg.ssm.expand * d
    nst, dh = cfg.ssm.state_dim, cfg.ssm.head_dim
    nheads = d_in // dh
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * nst]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * nst:]
    if carry is None:
        conv_state = None
        h0 = torch.zeros(b, nheads, dh, nst, dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = carry
    exact = exact or carry is not None or n_valid is not None
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], conv_state, n_valid, exact)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(b, s, nheads, dh)
    B = xbc[..., d_in:d_in + nst]
    C = xbc[..., d_in + nst:]
    dt_v = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt_v * A)
    if _chunked(cfg.ssm.chunk, s, n_valid):
        y, h_final = _ssd_chunked(xs, B, C, dt_v, decay, h0, cfg.ssm.chunk)
    else:
        y, h_final = _ssd_recurrent(xs, B, C, dt_v, decay, h0, n_valid)
    y = y + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_in).to(dt_)
    y = gn_rmsnorm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"], (conv_state, h_final)


def mamba2_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    """One layer's Mamba2 carries, name -> (shape, dtype): (conv, h)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    return {"conv": ((batch, s.conv_dim - 1, d_in + 2 * s.state_dim), getattr(torch, cfg.dtype)),
            "h": ((batch, nheads, s.head_dim, s.state_dim), torch.float32)}
