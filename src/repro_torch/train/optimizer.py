"""AdamW over nested dicts of tensors, with global-norm clipping, a warmup
then cosine schedule and optional int8 error-feedback gradient compression
(port of ``repro/train/optimizer.py``).

Plain functions, run without autograd.  Trees are nested dicts (and tuples)
of tensors with the reference's keys; every reduction over a tree walks its
leaves in the reference's order (dict keys sorted, as ``jax.tree.leaves``).
``adamw_update`` writes the new parameters and moments into the tensors it
is given, in place, and returns those trees: at full width a functional
update would hold a second copy of the parameters and both moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compression: Optional[int] = None  # bits (e.g. 8) or None
    state_dtype: str = "float32"  # Adam m/v storage dtype


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/tuple/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of the nested dict ``tree`` and of the
    same-keyed ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio, in f32 (``step``: an
    int or a tensor; the result lies on the tensor's device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(cfg: OptimizerConfig, params) -> dict:
    """Zero moments in ``state_dtype`` beside each parameter, step 0 (int32,
    on the parameters' device), and the error-feedback residual when
    compressing."""
    sdt = getattr(torch, cfg.state_dtype)
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params)  # noqa: E731
    device = tree_leaves(params)[0].device
    state = {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32,
                                                            device=device)}
    if cfg.grad_compression:
        state["ef_error"] = zeros()
    return state


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling as a 0-d f32 tensor)."""
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


@torch.no_grad()
def compress_with_error_feedback(grads, error, bits: int):
    """Per-tensor symmetric int-``bits`` quantization with error feedback:
    (the dequantized gradients, the new residuals).  The residual stays
    local and is added back the next step (EF-SGD)."""
    qmax = float(2 ** (bits - 1) - 1)

    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp(g32.abs().max(), min=1e-12) / qmax
        deq = torch.clamp(torch.round(g32 / scale), -qmax, qmax) * scale
        return deq.to(g.dtype), g32 - deq

    pairs = tree_map(one, grads, error)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step: (params, state, metrics) with ``metrics`` = {"grad_norm",
    "lr"} as 0-d tensors.  The parameters and moments are updated in place
    (moments in f32, stored at ``state_dtype``); the trees returned are the
    ones given, ``state["step"]`` a new tensor."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    metrics = {"grad_norm": gnorm}
    if cfg.grad_compression:
        grads, new_err = compress_with_error_feedback(grads, state["ef_error"],
                                                      cfg.grad_compression)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = b1 * m.float() + (1 - b1) * g32
        v_new = b2 * v.float() + (1 - b2) * g32.square()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if cfg.grad_compression:
        new_state["ef_error"] = new_err
    metrics["lr"] = lr
    return params, new_state, metrics
