"""Train-step factory: loss -> grads -> (clip, compress) -> AdamW (port of
``repro/train/loop.py``).

``make_train_step(model, opt_cfg, microbatches)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
over f32 master parameters on one device.  Each microbatch casts the masters
for compute (``Model.prepare``: matmul leaves to ``cfg.dtype``, the rest
f32), runs the loss forward through the GN kernels (the CUDA kernels on the
card, their plain versions on the CPU) and its backward (the kernels'
``autograd.Function``s), and takes the gradients of the masters in f32.
With ``microbatches > 1`` the batch splits along dim 0 and loss, metrics
and gradients are summed over the microbatches, then scaled by
1/microbatches, as the reference's scan.  The update is ``adamw_update``,
in place.  Metrics: ``loss``, ``nll``, ``grad_norm`` and ``lr``, 0-d
tensors on the device.

Under a sharding context (``parallel.sharding.use_sharding``) the masters
are DTensors (``distribute_params``): each microbatch goes in with its batch
dim on the ``batch`` axes, the forward and backward run on DTensors (plain
tensors such as positions and the learning rate taken as replicated), each
gradient is placed as its parameter (a partial sum reduce-scattered), the
clipping norm is the global one over every shard, and the metrics come back
as plain tensors, the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import current_ctx, is_dtensor, place_tree
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, tree_leaves, tree_map


def _device_of(params) -> torch.device:
    return params["embed"]["tok"].device


def _batch_on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _sharded_batch(batch: dict) -> dict:
    """A (micro)batch's leaves as DTensors, the batch dim on the ``batch``
    axes (the reference's ``shard(v, "batch", ...)``); as they are without a
    sharding context."""
    ctx = current_ctx()
    if ctx is None:
        return batch
    return place_tree(batch, {k: ctx.placements(tuple(v.shape), ("batch",))
                              for k, v in batch.items()}, ctx.mesh)


def _plain(t):
    """A DTensor metric as the plain tensor every rank holds."""
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model: Model, opt_cfg: OptimizerConfig, microbatches: int = 1):
    def grads_of(params, batch):
        """(loss, metrics, f32 gradients of the masters) of one microbatch;
        under a sharding context each gradient placed as its master."""
        batch = _sharded_batch(batch)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.loss(model.prepare(leaves, _device_of(params)), batch)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat)
        by_id = {id(t): (g.float().redistribute(placements=t.placements) if is_dtensor(g)
                         else g.float()) for t, g in zip(flat, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda t: by_id[id(t)], leaves))

    def train_step(params, opt_state, batch):
        if current_ctx() is None:
            return step(params, opt_state, batch)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    def step(params, opt_state, batch):
        batch = _batch_on(batch, _device_of(params))
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into {microbatches} microbatches")
            size = n // microbatches
            loss = metrics = grads = None
            for i in range(microbatches):
                one = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_i, m_i, g_i = grads_of(params, one)
                if grads is None:
                    loss, metrics, grads = l_i, m_i, g_i
                else:
                    loss = loss + l_i
                    metrics = {k: metrics[k] + m_i[k] for k in metrics}
                    tree_map(lambda acc, g: acc.add_(g), grads, g_i)
                del g_i
            inv = 1.0 / microbatches
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            tree_map(lambda g: g.mul_(inv), grads)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_eval_step(model: Model):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(model.prepare(params, _device_of(params)),
                                    _batch_on(batch, _device_of(params)))
        return metrics

    return eval_step
