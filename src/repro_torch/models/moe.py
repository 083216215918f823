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

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _softmax
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.sharding import current_ctx, grad_placements, is_dtensor

_tls = threading.local()  # a lockstep shard's (TickExchange, index)
# seconds a lockstep shard waits at an MoE layer for the others before it
# gives the tick up (a shard that raises releases the others at once)
BARRIER_TIMEOUT = 600.0


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    # the reference's: experts over "expert" (EP) when their count divides the
    # production TP width (16), else TP within every expert
    if e % 16 == 0:
        wi_ax, wo_ax = ("expert", "embed_fsdp", None), ("expert", None, "embed_fsdp")
    else:
        wi_ax, wo_ax = (None, "embed_fsdp", "ff"), (None, "ff", "embed_fsdp")
    return {
        "router": ParamSpec((d, e), ("embed_fsdp", None)),
        "wi": ParamSpec((e, d, f), wi_ax),
        "wg": ParamSpec((e, d, f), wi_ax),
        "wo": ParamSpec((e, f, d), wo_ax),
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


def group_size(cfg: ModelConfig, tokens: int, group_tokens: int = 0) -> int:
    """The GShard group of ``tokens`` routed together: ``min(group_size,
    group_tokens or tokens)``, which must split them (and ``group_tokens``)
    evenly, as the reference asserts."""
    g_sz = min(cfg.moe.group_size, group_tokens or tokens)
    if tokens % g_sz or (group_tokens and group_tokens % g_sz):
        raise ValueError(f"MoE: {tokens} tokens do not split into groups of {g_sz}")
    return g_sz


def capacity(cfg: ModelConfig, g_sz: int) -> int:
    """Each expert's slots in a group of ``g_sz`` tokens (Python float
    arithmetic on ints, as the reference computes it)."""
    m = cfg.moe
    return max(int(g_sz * m.top_k * m.capacity_factor / m.num_experts), 1)


def route(cfg: ModelConfig, p: dict, x: torch.Tensor, group_tokens: int = 0,
          g_sz: int | None = None) -> dict:
    """The routing of x (B, S, D): the groups, ``cap``, the router logits
    and gates (G, T, E) f32, the top-k (idx, val) (G, T, k), the one-hot
    choices (G, T, k, E), each choice's capacity slot and whether it is
    kept.  ``n_groups * g_sz == tokens`` is required, as the reference
    asserts it.  ``group_tokens`` > 0 routes each run of that many tokens
    as the reference routes a batch of them alone (its groups never span
    two runs); ``g_sz`` fixes the group (a shard of a larger batch routes
    in the whole batch's groups)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    g_sz = g_sz or group_size(cfg, b * s, group_tokens)
    n_groups = b * s // g_sz
    cap = capacity(cfg, g_sz)
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


def _dispatch(cfg: ModelConfig, p: dict, r: dict, keep: torch.Tensor,
              experts: slice = slice(None)) -> torch.Tensor:
    """y (G, T, D) of the routing ``r`` with the choices ``keep`` kept: the
    kept tokens dispatched into their (expert, slot) cells, the experts
    ``experts`` of them run on the weights of ``p`` (which hold only those
    experts when it is a part of E: y is then their share of the sum), and
    the cells combined back by the gate values."""
    xg, cap, idx, val = r["xg"], r["cap"], r["idx"], r["val"]
    dt = xg.dtype
    n_groups, g_sz, d = xg.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    if cfg.moe_dispatch == "gather":
        tk = g_sz * k
        dest = torch.where(keep, idx * cap + r["slot"], e * cap).reshape(n_groups, tk)
        tok_of = torch.arange(g_sz, device=xg.device)[:, None].expand(g_sz, k).reshape(tk)
        # the dropped choices all land in the extra last cell, cut away after
        src = torch.zeros(n_groups, e * cap + 1, dtype=torch.long, device=xg.device)
        src.scatter_(1, dest, tok_of.expand(n_groups, tk))
        filled = torch.zeros(n_groups, e * cap + 1, dtype=dt, device=xg.device)
        filled.scatter_(1, dest, torch.ones(n_groups, tk, dtype=dt, device=xg.device))
        src, filled = src[:, :-1], filled[:, :-1]
        expert_in = torch.gather(xg, 1, src[..., None].expand(-1, -1, d)) * filled[..., None]
        expert_in = expert_in.reshape(n_groups, e, cap, d)
        if experts == slice(None):
            expert_out = _experts(p, expert_in)
        else:  # the other ranks' experts give zeros here
            expert_out = torch.zeros_like(expert_in)
            expert_out[:, experts] = _experts(p, expert_in[:, experts])
        flat_out = expert_out.reshape(n_groups, e * cap, d)
        back = torch.gather(flat_out, 1, dest.clamp_max(e * cap - 1)[..., None].expand(-1, -1, d))
        w = (val.to(dt) * keep.to(dt)).reshape(n_groups, g_sz, k)
        return torch.einsum("gtk,gtkd->gtd", w, back.reshape(n_groups, g_sz, k, d))
    # "einsum": the GShard one-hot dispatch and combine
    slot_oh = _one_hot(r["slot"], cap, dt)  # (g, t, k, cap)
    exp_oh_d = (r["onehot"].to(dt) * keep[..., None].to(dt))[..., experts]  # (g, t, k, e)
    dispatch = torch.einsum("gtke,gtkc->gtec", exp_oh_d, slot_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh_d, slot_oh, val.to(dt))
    expert_out = _experts(p, torch.einsum("gtec,gtd->gecd", dispatch, xg))
    return torch.einsum("gtec,gecd->gtd", combine, expert_out)


def _group_stats(cfg: ModelConfig, r: dict) -> tuple:
    """The per-group terms of the aux losses: (density · prob_mass summed
    over experts (G,), logsumexp(logits)² (G, T), keep (G, T, k) f32)."""
    keep = r["keep"]
    exp_oh = r["onehot"].float() * keep[..., None].float()
    density = exp_oh.sum(2).mean(dim=1)  # (g, e) fraction routed
    prob_mass = r["gates"].mean(dim=1)  # (g, e)
    return ((density * prob_mass).sum(-1), torch.logsumexp(r["logits"], -1).square(),
            keep.float())


def _moe_groups(cfg: ModelConfig, p: dict, x: torch.Tensor, g_sz: int,
                experts: slice = slice(None)):
    """(y (B, S, D), the per-group stats) of x routed in groups of ``g_sz``."""
    r = route(cfg, p, x, g_sz=g_sz)
    return _dispatch(cfg, p, r, r["keep"], experts).reshape(x.shape), _group_stats(cfg, r)


def _moe_sharded(cfg: ModelConfig, p: dict, x, g_sz: int, ctx):
    """``_moe_groups`` over the local shards of a DTensor x (B, S, D), as two
    local calls.  The routing: the groups follow ``"group"`` (on the data
    axes when they split x's batch into whole groups on every rank, else
    every rank routes them all), the router gathered over ``embed_fsdp``.
    The experts: gathered over ``embed_fsdp`` and left split over
    ``"expert"`` (EP: each rank runs its own experts) or their ``"ff"`` dim
    (TP within each) as the rules place them; y is the sum of those ranks'
    shares (``Partial``).  Apart, each call's gradients sum over the ranks
    that computed different parts of it (``grad_placements``): the routing,
    the same on every model rank, counts once."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    b, s, d = x.shape
    names = ctx.axis_names
    rows = ctx.spec_for_shape((b,), ("group",))[0]
    ranks = 1
    for a in (rows if isinstance(rows, tuple) else (rows,) if rows else ()):
        ranks *= ctx.mesh.size(names.index(a))
    group_axis = "group" if rows is not None and (b // ranks * s) % g_sz == 0 else None
    experts = ("wi", "wg", "wo")
    w_axes = {k: tuple(None if a == "embed_fsdp" else a
                       for a in moe_specs(cfg)[k].logical_axes) for k in ("router", *experts)}
    w_pl = {k: ctx.placements(tuple(p[k].shape), w_axes[k]) for k in w_axes}
    x_pl = ctx.placements((b, s, d), (group_axis, None, None))
    g_pl = ctx.placements((b,), (group_axis,))  # every per-group output: groups first
    # the mesh axes that split the expert weights: y sums over them
    split = {i for k in experts for i, one in enumerate(w_pl[k]) if one != Replicate()}
    y_pl = [Partial() if i in split else one for i, one in enumerate(x_pl)]
    ep = ctx.spec_for_shape(tuple(p["wi"].shape), w_axes["wi"])[0]

    def routing(x, router):
        r = route(cfg, {"router": router}, x, g_sz=g_sz)
        return (r["idx"], r["val"], r["slot"], r["keep"], *_group_stats(cfg, r))

    def dispatch(x, idx, val, slot, keep, wi, wg, wo):
        e = cfg.moe.num_experts
        own = slice(None)
        if ep is not None:  # this rank's experts of the E, in mesh order
            n = 0
            for a in (ep if isinstance(ep, tuple) else (ep,)):
                n = n * ctx.mesh.size(names.index(a)) + ctx.mesh.get_local_rank(a)
            own = slice(n * wi.shape[0], (n + 1) * wi.shape[0])
        r = {"xg": x.reshape(-1, g_sz, x.shape[-1]), "idx": idx, "val": val, "slot": slot,
             "onehot": _one_hot(idx, e, torch.int32), "cap": capacity(cfg, g_sz)}
        return _dispatch(cfg, {"wi": wi, "wg": wg, "wo": wo}, r, keep, own).reshape(x.shape)

    def call(fn, out_pl, in_pl, *args):
        return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_placements(in_pl), device_mesh=ctx.mesh,
                         redistribute_inputs=True)(*args)

    idx, val, slot, keep, *stats = call(routing, (g_pl,) * 7, (x_pl, w_pl["router"]), x,
                                        p["router"])
    y = call(dispatch, y_pl, (x_pl, g_pl, g_pl, g_pl, g_pl, *(w_pl[k] for k in experts)),
             x, idx, val, slot, keep, *(p[k] for k in experts))
    return y, tuple(stats)


class TickExchange:
    """The shards of one sharded serving tick in lockstep at each MoE layer
    (one thread a shard): every shard hands in its router input (n_d, C, D)
    and takes every shard's, copied onto its own device and concatenated in
    slot order, so each routes the whole tick's tokens as one GShard group,
    as one device's tick does, and applies the experts to its own tokens
    with the global capacity slots.  A shard that fails aborts the barrier,
    so no other waits for it."""

    def __init__(self, shards: int):
        self._parts: list = [None] * shards
        self._barrier = threading.Barrier(shards, timeout=BARRIER_TIMEOUT)

    @contextlib.contextmanager
    def shard(self, index: int):
        """Run the caller's MoE layers as shard ``index`` of the tick."""
        prev = getattr(_tls, "exchange", None)
        _tls.exchange = (self, index)
        try:
            yield
        except BaseException:
            self._barrier.abort()
            raise
        finally:
            _tls.exchange = prev

    def apply(self, index: int, cfg: ModelConfig, p: dict, x: torch.Tensor):
        """Shard ``index``'s (y, per-group stats) of its rows x."""
        self._parts[index] = x
        self._barrier.wait()
        parts = [t.to(x.device) for t in self._parts]
        self._barrier.wait()  # every shard holds its copies before the next layer's hand-in
        full = torch.cat(parts)
        lo, n = sum(t.shape[0] for t in parts[:index]), x.shape[0]
        r = route(cfg, p, full, g_sz=group_size(cfg, full.shape[0] * full.shape[1]))
        own = torch.zeros(full.shape[:2], dtype=torch.bool, device=x.device)
        own[lo:lo + n] = True
        keep = r["keep"] & own.reshape(r["keep"].shape[:2])[..., None]
        return _dispatch(cfg, p, r, keep).reshape(full.shape)[lo:lo + n], _group_stats(cfg, r)


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, group_tokens: int = 0):
    """x: (B, S, D) -> (y (B, S, D), aux): aux the reference's load-balance
    loss, router z-loss and dropped fraction (0-d f32).  p holds the
    weights in x's dtype (``Model.prepare``); ``group_tokens`` as ``route``.
    Under a sharding context with DTensor weights the groups run over local
    shards (``_moe_sharded``); a shard of a sharded serving tick in lockstep
    (``TickExchange``) routes the whole tick's tokens as one device's
    tick would and applies the experts to its own."""
    b, s, d = x.shape
    ctx = current_ctx()
    exchange = getattr(_tls, "exchange", None)
    if ctx is not None and is_dtensor(x):
        y, stats = _moe_sharded(cfg, p, x, group_size(cfg, b * s, group_tokens), ctx)
    elif exchange is not None and not group_tokens:
        y, stats = exchange[0].apply(exchange[1], cfg, p, x)
    else:
        y, stats = _moe_groups(cfg, p, x, group_size(cfg, b * s, group_tokens))
    lb, z, keep = stats
    aux = {"load_balance": cfg.moe.num_experts * lb.mean(), "router_z": z.mean(),
           "dropped_frac": 1.0 - keep.mean()}
    return y, aux
