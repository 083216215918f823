"""Dense-family model (port of the dense paths of
``repro/models/transformer.py``).

``Model(cfg)`` exposes:
  * ``param_specs()`` / ``init(seed, device)`` — the reference's parameter
    tree (stacked ``layers``), f32 masters, drawn from a ``torch.Generator``;
  * ``prepare(params, device)``                 — the tree the forward runs on:
    moved to the device, the matmul weights cast once to ``cfg.dtype``
    (what the reference's ``.astype(dt)`` at every einsum computes), and
    ``layers`` split into a per-layer list of views;
  * ``forward``                                 — teacher-forced logits over
    every position, self-attention through the GN flash-attention kernel;
  * ``cache_specs`` / ``init_cache`` / ``prefill`` / ``decode_step`` — the
    static path over a dense slab cache (L, B, max_seq, KV, dh) per k and v,
    written in place, its score rows through the GN softmax kernel;
  * ``init_paged_cache`` / ``fused_step_slots_paged`` / ``_paged_head`` —
    the block-paged serving tick over fp arenas.

Each layer runs norm -> attention -> norm -> MLP; the head runs one more
norm and the LM projection.  Projections stay ``torch.matmul``, as the
reference leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_specs,
    init_tree,
    lm_head_specs,
    mlp_specs,
    norm_specs,
    stack_specs,
)

# leaves the forward multiplies in the activation dtype; norms stay f32 and
# the embedding table stays f32 (rows are gathered first, then cast)
_MATMUL_LEAVES = {"wq", "wk", "wv", "wo", "wi", "wg", "w"}


def _tree_map(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


class Model:
    def __init__(self, cfg: ModelConfig):
        if (cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None
                or cfg.sliding_window):
            raise NotImplementedError(
                f"{cfg.name}: only the dense full-attention family is ported")
        self.cfg = cfg

    def param_specs(self) -> dict:
        cfg = self.cfg
        block = {"ln1": norm_specs(cfg), "mixer": attn.attn_specs(cfg),
                 "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}
        return {
            "embed": embed_specs(cfg),
            "layers": stack_specs(block, cfg.n_layers),
            "final_norm": norm_specs(cfg),
            "lm_head": lm_head_specs(cfg),
        }

    def init(self, seed: int = 0, device=None) -> dict:
        """Random f32 parameters (normal * 0.02, ones, zeros) from ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return init_tree(self.param_specs(), gen, dev)

    def prepare(self, params: dict, device=None) -> dict:
        """Parameters as the forward uses them (see module docstring)."""
        dev = resolve_device(device)
        dt = getattr(torch, self.cfg.dtype)
        tree = _tree_map(
            lambda k, t: t.to(dev, dt if k in _MATMUL_LEAVES else torch.float32),
            params,
        )
        stacked = tree["layers"]
        tree["layers"] = [
            _tree_map(lambda _, t, i=i: t[i], stacked) for i in range(self.cfg.n_layers)
        ]
        return tree

    def _embed(self, params, tokens):
        """Token rows of the f32 table, cast to the activation dtype (the
        reference casts the table first: the same values)."""
        return params["embed"]["tok"][tokens.long()].to(getattr(torch, self.cfg.dtype))

    def _mlp_residual(self, lp, x):
        return x + apply_mlp(self.cfg, lp["mlp"], apply_norm(self.cfg, lp["ln2"], x))

    # --------------------------------------------------------- static path --
    def forward(self, params, batch: dict):
        """Teacher-forced logits (B, S, V) of batch["tokens"] (B, S).  The
        reference also returns MoE aux losses, which the dense family lacks."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device).expand(tokens.shape)
        for lp in params["layers"]:
            h = apply_norm(cfg, lp["ln1"], x)
            x = self._mlp_residual(lp, x + attn.self_attention(cfg, lp["mixer"], h, positions))
        return self._lm_head(params, x)

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """The static path's slab cache, name -> (shape, dtype):
        (L, B, max_seq, KV, dh) per k and v."""
        per_layer = attn.attn_cache_shape(self.cfg, batch, max_seq)
        return {k: ((self.cfg.n_layers, *shape), dt) for k, (shape, dt) in per_layer.items()}

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        dev = resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in self.cache_specs(batch, max_seq).items()}

    def prefill(self, params, batch: dict, max_seq: int | None = None):
        """Prompt pass over batch["tokens"] (B, S).  Returns the logits
        (B, S, V) of every position and a new slab cache of ``max_seq``
        (default S) slots holding the prompt's K/V at [0, S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        cache = self.init_cache(b, max_seq or s, x.device)
        positions = torch.arange(s, device=x.device).expand(b, s)
        for lp, k_slab, v_slab in zip(params["layers"], cache["k"], cache["v"]):
            y, kv = attn.attn_prefill(cfg, lp["mixer"], apply_norm(cfg, lp["ln1"], x), positions)
            k_slab[:, :s] = kv["k"]
            v_slab[:, :s] = kv["v"]
            x = self._mlp_residual(lp, x + y)
        return self._lm_head(params, x), cache

    def decode_step(self, params, cache, token, pos: int):
        """token: (B, 1) at position ``pos`` (a Python int).  Writes slot
        ``pos`` of every layer's slabs in place; returns (logits (B, 1, V),
        cache)."""
        cfg = self.cfg
        x = self._embed(params, token)
        for lp, k_slab, v_slab in zip(params["layers"], cache["k"], cache["v"]):
            h = apply_norm(cfg, lp["ln1"], x)
            y, _ = attn.attn_decode_step(cfg, lp["mixer"], {"k": k_slab, "v": v_slab}, h, pos)
            x = self._mlp_residual(lp, x + y)
        return self._lm_head(params, x), cache

    # ---------------------------------------------------------- paged tick --
    def init_paged_cache(self, num_blocks: int, block_size: int, device=None) -> dict:
        """fp block arenas (L, num_blocks + 1, block_size, KV, dh); the extra
        block is the write sink of ``attention.paged_write_indices``."""
        cfg = self.cfg
        shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
        dt = getattr(torch, cfg.dtype)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def fused_step_slots_paged(self, params, cache, tokens, positions, n_valid, tables):
        """One paged serving tick: every slot processes its own C-token chunk
        at its own write offset.  params: ``prepare``d; tokens: (N, C) int;
        positions/n_valid: (N,) int32 (n_valid = 0 parks a lane: no writes);
        tables: (N, max_bt) int32.  Writes the arenas of ``cache`` in place and
        returns the logits (N, 1, V) of each slot's row n_valid - 1."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        for lp, k_arena, v_arena in zip(params["layers"], cache["k"], cache["v"]):
            h = apply_norm(cfg, lp["ln1"], x)
            x = self._mlp_residual(lp, x + attn.attn_paged_chunk(
                cfg, lp["mixer"], k_arena, v_arena, h, positions, n_valid, tables))
        return self._paged_head(params, x, n_valid)

    def _paged_head(self, params, x, n_valid):
        """Next-token logits per slot: gather row n_valid - 1 (clamped for
        parked lanes), then project only that row."""
        idx = (n_valid.long() - 1).clamp_min(0)
        xr = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        return self._lm_head(params, xr)

    def _lm_head(self, params, x):
        return apply_norm(self.cfg, params["final_norm"], x) @ params["lm_head"]["w"]


def make_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
