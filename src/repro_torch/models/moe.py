"""Mixture-of-Experts MLP: GShard grouped top-k dispatch (port of
``repro/models/moe.py``).

Tokens are split into groups of ``min(group_size, tokens)``; each group
routes its tokens to experts under a per-group capacity ``cap``, earlier
top-k choices claiming capacity first, then earlier tokens, and a choice past
``cap`` is dropped.  The router softmax is score-oriented: its
probabilities weight the expert outputs and feed the load-balance loss, so
it runs through ``cfg.softmax_impl`` (for ``"gn"`` the GN softmax kernel's
wrapper over the (groups, tokens, experts) f32 rows).

Routing couples the rows of a group: every token of a group, live or not,
competes for the same ``cap`` slots.  A paged serving tick is one group
(N * C tokens), so its parked lanes and the lanes past a slot's ``n_valid``
take part in the routing exactly as in the reference.  The reference's slab
tick vmaps its step over the slots, so each slot's C lanes route as a batch
of their own: the slab tick passes ``group_tokens=C``.

Both dispatches of the reference are ported: ``"einsum"`` (the GShard
one-hot dispatch/combine products, the default) and ``"gather"`` (the
kept (token, choice) pairs scattered into their (expert, slot) cells).
The expert products are plain ``torch.einsum``, as the reference leaves
them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _softmax
from repro_torch.models.layers import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": ParamSpec((d, e)),
        "wi": ParamSpec((e, d, f)),
        "wg": ParamSpec((e, d, f)),
        "wo": ParamSpec((e, f, d)),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(gates: torch.Tensor, k: int):
    """Iterative top-k over the last dim, the reference's: argmax, then the
    chosen gate pushed down by 1e9.  Ties go to the first index, as
    ``jnp.argmax`` (and ``torch.argmax``, on the CPU and on the card) break
    them.  Returns (indices, values), each (..., k)."""
    idxs, vals = [], []
    g = gates
    for _ in range(k):
        i = torch.argmax(g, dim=-1)
        idxs.append(i)
        vals.append(torch.gather(g, -1, i[..., None])[..., 0])
        g = g - _one_hot(i, gates.shape[-1], g.dtype) * 1e9
    return torch.stack(idxs, -1), torch.stack(vals, -1)


def route(cfg: ModelConfig, p: dict, x: torch.Tensor, group_tokens: int = 0) -> dict:
    """The routing of x (B, S, D): the groups, ``cap``, the router logits
    and gates (G, T, E) f32, the top-k (idx, val) (G, T, k), the one-hot
    choices (G, T, k, E), each choice's capacity slot and whether it is
    kept.  ``n_groups * g_sz == tokens`` is required, as the reference
    asserts it.  ``group_tokens`` > 0 routes each run of that many tokens
    as the reference routes a batch of them alone (its groups never span
    two runs)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = b * s
    g_sz = min(m.group_size, group_tokens or tokens)
    n_groups = tokens // g_sz
    if n_groups * g_sz != tokens or (group_tokens and group_tokens % g_sz):
        raise ValueError(f"MoE: {tokens} tokens do not split into groups of {g_sz}")
    # Python float arithmetic on ints, as the reference computes it
    cap = max(int(g_sz * k * m.capacity_factor / e), 1)
    xg = x.reshape(n_groups, g_sz, d)
    logits = (xg @ p["router"]).float()
    gates = _softmax(cfg)(logits)
    idx, val = _top_k(gates, k)
    val = val / torch.clamp_min(val.sum(-1, keepdim=True), 1e-9)
    onehot = _one_hot(idx, e, torch.int32)  # (g, t, k, e)
    flat = onehot.reshape(n_groups, g_sz * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g_sz, k, e)
    in_cap = (pos < cap) & (onehot > 0)
    return {"xg": xg, "cap": cap, "logits": logits, "gates": gates, "idx": idx, "val": val,
            "onehot": onehot, "slot": (pos * onehot).sum(-1), "keep": in_cap.any(-1)}


def _experts(p: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts over (G, E, cap, D) -> (G, E, cap, D)."""
    h = torch.einsum("gecd,edf->gecf", expert_in, p["wi"])
    gate = torch.einsum("gecd,edf->gecf", expert_in, p["wg"])
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * h, p["wo"])


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, group_tokens: int = 0):
    """x: (B, S, D) -> (y (B, S, D), aux): aux the reference's load-balance
    loss, router z-loss and dropped fraction (0-d f32).  p holds the
    weights in x's dtype (``Model.prepare``); ``group_tokens`` as ``route``."""
    dt = x.dtype
    b, s, d = x.shape
    r = route(cfg, p, x, group_tokens)
    xg, cap, idx, val, keep = r["xg"], r["cap"], r["idx"], r["val"], r["keep"]
    n_groups, g_sz = xg.shape[:2]
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    if cfg.moe_dispatch == "gather":
        tk = g_sz * k
        dest = torch.where(keep, idx * cap + r["slot"], e * cap).reshape(n_groups, tk)
        tok_of = torch.arange(g_sz, device=x.device)[:, None].expand(g_sz, k).reshape(tk)
        # the dropped choices all land in the extra last cell, cut away after
        src = torch.zeros(n_groups, e * cap + 1, dtype=torch.long, device=x.device)
        src.scatter_(1, dest, tok_of.expand(n_groups, tk))
        filled = torch.zeros(n_groups, e * cap + 1, dtype=dt, device=x.device)
        filled.scatter_(1, dest, torch.ones(n_groups, tk, dtype=dt, device=x.device))
        src, filled = src[:, :-1], filled[:, :-1]
        expert_in = torch.gather(xg, 1, src[..., None].expand(-1, -1, d)) * filled[..., None]
        expert_out = _experts(p, expert_in.reshape(n_groups, e, cap, d))
        flat_out = expert_out.reshape(n_groups, e * cap, d)
        back = torch.gather(flat_out, 1, dest.clamp_max(e * cap - 1)[..., None].expand(-1, -1, d))
        w = (val.to(dt) * keep.to(dt)).reshape(n_groups, g_sz, k)
        y = torch.einsum("gtk,gtkd->gtd", w, back.reshape(n_groups, g_sz, k, d))
    else:  # "einsum": the GShard one-hot dispatch and combine
        slot_oh = _one_hot(r["slot"], cap, dt)  # (g, t, k, cap)
        exp_oh_d = r["onehot"].to(dt) * keep[..., None].to(dt)  # (g, t, k, e)
        dispatch = torch.einsum("gtke,gtkc->gtec", exp_oh_d, slot_oh)
        combine = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh_d, slot_oh, val.to(dt))
        expert_out = _experts(p, torch.einsum("gtec,gtd->gecd", dispatch, xg))
        y = torch.einsum("gtec,gecd->gtd", combine, expert_out)
    exp_oh = r["onehot"].float() * keep[..., None].float()
    density = exp_oh.sum(2).mean(dim=1)  # (g, e) fraction routed
    prob_mass = r["gates"].mean(dim=1)  # (g, e)
    aux = {"load_balance": e * (density * prob_mass).sum(-1).mean(),
           "router_z": torch.logsumexp(r["logits"], -1).square().mean(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y.reshape(b, s, d), aux
