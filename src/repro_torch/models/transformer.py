"""Dense-family model (port of the dense paths of
``repro/models/transformer.py``).

``Model(cfg)`` exposes:
  * ``param_specs()`` / ``init(seed, device)`` — the reference's parameter
    tree (stacked ``layers``), f32 masters, drawn from a ``torch.Generator``;
  * ``prepare(params, device)``                 — the tree the forward runs on:
    moved to the device, the matmul weights cast once to ``cfg.dtype``
    (what the reference's ``.astype(dt)`` at every einsum computes), and
    ``layers`` split into a per-layer list of views; differentiable, so a
    training step runs it on f32 masters that require grad (the
    reference's ``_cast_for_compute``) and the gradients reach them;
  * ``forward``                                 — teacher-forced logits over
    every position, self-attention through the GN flash-attention kernel
    (or the one-pass exact softmax); ``loss`` — the mean next-token NLL;
  * ``cache_specs`` / ``init_cache`` / ``prefill`` / ``decode_step`` — the
    static path over a dense slab cache (L, B, max_seq, KV, dh) per k and v,
    written in place, its score rows through the GN softmax kernel; the
    decode step takes its position as a device tensor too, so one CUDA
    graph serves every step;
  * ``init_paged_cache`` / ``fused_step_slots_paged`` / ``_paged_head`` —
    the block-paged serving tick over fp arenas, or int8 arenas with
    per-block f32 scales, its read named by ``paged_read_path``, and with
    ``sentinel`` the GN sentinels' per-layer and head probes.

Each layer runs norm -> attention -> norm -> MLP; the head runs one more
norm and the LM projection.  Every norm that follows a residual add (ln2,
and ln1 of every layer but the first) takes the add with it in one fused
launch (``apply_add_norm``): a layer's MLP output is carried into the next
layer's ln1, and the last one is added before the head.  Projections stay
``torch.matmul``, as the reference leaves them to XLA outside any Pallas
kernel.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_add_norm,
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
        # one unbind a leaf: its backward stacks the layers' gradients once
        unbound = _tree_map(lambda _, t: t.unbind(0), tree["layers"])
        tree["layers"] = [
            _tree_map(lambda _, t, i=i: t[i], unbound) for i in range(self.cfg.n_layers)
        ]
        return tree

    def _embed(self, params, tokens):
        """Token rows of the f32 table, cast to the activation dtype (the
        reference casts the table first: the same values)."""
        return params["embed"]["tok"][tokens.long()].to(getattr(torch, self.cfg.dtype))

    def _ln1(self, lp, x, pending):
        """(residual stream, ln1 input): the previous layer's MLP output
        ``pending`` (None in layer 0) added in by the fused norm."""
        if pending is None:
            return x, apply_norm(self.cfg, lp["ln1"], x)
        return apply_add_norm(self.cfg, lp["ln1"], x, pending)

    def _mlp_residual(self, lp, x, y):
        """Adds the attention output y to the residual stream x, then ln2 and
        the MLP: (residual stream, MLP output still to be added)."""
        x, h = apply_add_norm(self.cfg, lp["ln2"], x, y)
        return x, apply_mlp(self.cfg, lp["mlp"], h)

    # --------------------------------------------------------- static path --
    def forward(self, params, batch: dict):
        """Teacher-forced logits (B, S, V) of batch["tokens"] (B, S).  The
        reference also returns MoE aux losses, which the dense family lacks."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device).expand(tokens.shape)
        pending = None
        for lp in params["layers"]:
            x, h = self._ln1(lp, x, pending)
            x, pending = self._mlp_residual(
                lp, x, attn.self_attention(cfg, lp["mixer"], h, positions))
        return self._lm_head(params, x + pending)

    def loss(self, params, batch: dict):
        """(mean next-token NLL, {"nll": it}) of batch["tokens"] (B, S): the
        f32 log-softmax of the shifted logits, as the reference's dense
        ``Model.loss`` (its MoE terms do not apply).  Differentiable through
        ``prepare`` back to f32 masters."""
        logits = self.forward(params, batch).float()[:, :-1]
        targets = torch.as_tensor(batch["tokens"]).to(logits.device)[:, 1:].long()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
        return loss, {"nll": loss}

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """The static path's slab cache, name -> (shape, dtype):
        (L, B, max_seq, KV, dh) per k and v."""
        per_layer = attn.attn_cache_shape(self.cfg, batch, max_seq)
        return {k: ((self.cfg.n_layers, *shape), dt) for k, (shape, dt) in per_layer.items()}

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        dev = resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in self.cache_specs(batch, max_seq).items()}

    def prefill(self, params, batch: dict, max_seq: int | None = None, cache: dict | None = None):
        """Prompt pass over batch["tokens"] (B, S).  Returns the logits
        (B, S, V) of every position and a slab cache of ``max_seq`` (default
        S) slots holding the prompt's K/V at [0, S) and zeros past it: a new
        one, or ``cache`` (``init_cache(B, max_seq)``'s shapes) zeroed and
        written in place, so a captured decode step can keep reading it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        if cache is None:
            cache = self.init_cache(b, max_seq or s, x.device)
        else:
            want = {k: shape for k, (shape, _) in self.cache_specs(b, max_seq or s).items()}
            if {k: tuple(v.shape) for k, v in cache.items()} != want:
                raise ValueError(f"cache shapes {[tuple(v.shape) for v in cache.values()]} "
                                 f"are not init_cache's {list(want.values())}")
            for slab in cache.values():
                slab.zero_()
        positions = torch.arange(s, device=x.device).expand(b, s)
        pending = None
        for lp, k_slab, v_slab in zip(params["layers"], cache["k"], cache["v"]):
            x, h = self._ln1(lp, x, pending)
            y, kv = attn.attn_prefill(cfg, lp["mixer"], h, positions)
            k_slab[:, :s] = kv["k"]
            v_slab[:, :s] = kv["v"]
            x, pending = self._mlp_residual(lp, x, y)
        return self._lm_head(params, x + pending), cache

    def decode_step(self, params, cache, token, pos):
        """token: (B, 1) at position ``pos``: a Python int, or a 0-d int32
        tensor on the cache's device (one CUDA graph then serves every
        position).  Writes slot ``pos`` of every layer's slabs in place;
        returns (logits (B, 1, V), cache)."""
        cfg = self.cfg
        x, pending = self._embed(params, token), None
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=x.device)
        for lp, k_slab, v_slab in zip(params["layers"], cache["k"], cache["v"]):
            x, h = self._ln1(lp, x, pending)
            y, _ = attn.attn_decode_step(cfg, lp["mixer"], {"k": k_slab, "v": v_slab}, h, pos)
            x, pending = self._mlp_residual(lp, x, y)
        return self._lm_head(params, x + pending), cache

    # ---------------------------------------------------------- paged tick --
    @property
    def paged_read_path(self) -> str:
        """The paged read the serving tick takes: ``"kernel"`` (the GN
        paged-attention kernel), or the reference's ``"streamed"`` or
        ``"gathered"`` read when ``attention.FORCE_PAGED_READ`` forces one.
        The engine fixes it at construction and reports it in ``metrics()``."""
        return attn.paged_read_path(self.cfg)

    def init_paged_cache(self, num_blocks: int, block_size: int, device=None,
                         kv_dtype: str = "fp") -> dict:
        """Block arenas "k", "v" (L, num_blocks + 1, block_size, KV, dh); the
        extra block is the write sink of ``attention.paged_write_indices``.
        ``kv_dtype="int8"`` stores the arenas in int8 and adds "k_scale" and
        "v_scale" (L, num_blocks + 1) f32, zeroed: the per-block dequant
        scales (the reference's ``<leaf>_scale`` leaves)."""
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        cfg = self.cfg
        shape = (cfg.n_layers, num_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
        dt = torch.int8 if kv_dtype == "int8" else getattr(torch, cfg.dtype)
        dev = resolve_device(device)
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
        if kv_dtype == "int8":
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros(shape[:2], dtype=torch.float32, device=dev)
        return cache

    def fused_step_slots_paged(self, params, cache, tokens, positions, n_valid, tables,
                               sentinel: bool = False):
        """One paged serving tick: every slot processes its own C-token chunk
        at its own write offset.  params: ``prepare``d; tokens: (N, C) int;
        positions/n_valid: (N,) int32 (n_valid = 0 parks a lane: no writes);
        tables: (N, max_bt) int32.  Writes the arenas of ``cache`` (and its
        scales, for int8 arenas) in place and returns the logits (N, 1, V) of
        each slot's row n_valid - 1.  With ``sentinel`` it also returns the
        GN sentinels' health, as the reference's: {"layers": (L, N, 3) f32,
        one ``attention.paged_probe_word`` a layer, "head": (N,) f32, the
        final norm's σ residual (``_paged_head``)}, computed on the device."""
        cfg = self.cfg
        x, pending = self._embed(params, tokens), None
        scales = (zip(cache["k_scale"], cache["v_scale"]) if "k_scale" in cache
                  else [None] * cfg.n_layers)
        probes = []
        for lp, k_arena, v_arena, sc in zip(params["layers"], cache["k"], cache["v"], scales):
            x, h = self._ln1(lp, x, pending)
            y = attn.attn_paged_chunk(cfg, lp["mixer"], k_arena, v_arena, h, positions, n_valid,
                                      tables, sc, probe=sentinel)
            if sentinel:
                y, pr = y
                probes.append(pr)
            x, pending = self._mlp_residual(lp, x, y)
        if not sentinel:
            return self._paged_head(params, x + pending, n_valid)
        logits, head = self._paged_head(params, x + pending, n_valid, probe=True)
        words = attn.paged_probe_word(
            probes, positions, n_valid, tables, cache["k"].shape[2],
            (cache["k_scale"], cache["v_scale"]) if "k_scale" in cache else None)
        return logits, {"layers": words, "head": head}

    def _paged_head(self, params, x, n_valid, probe: bool = False):
        """Next-token logits per slot: gather row n_valid - 1 (clamped for
        parked lanes), then project only that row.  With ``probe`` also the
        (N,) σ residual |mean(x̂²) − 1| of the model's own norm with unit
        gamma on the gathered row in f32 (the reference's probe), +inf where
        the row or its logits are nonfinite, 0 for parked lanes."""
        idx = (n_valid.long() - 1).clamp_min(0)
        xr = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        logits = self._lm_head(params, xr)
        if not probe:
            return logits
        xhat = apply_norm(self.cfg, {"gamma": None}, xr.float())
        sig = ((xhat * xhat).mean(dim=-1) - 1.0).abs()[:, 0]
        bad = ((~torch.isfinite(logits.float())).flatten(1).any(dim=1)
               | (~torch.isfinite(xr.float())).flatten(1).any(dim=1))
        head = torch.where(n_valid > 0, torch.where(bad, torch.inf, sig), 0.0)
        return logits, head

    def _lm_head(self, params, x):
        return apply_norm(self.cfg, params["final_norm"], x) @ params["lm_head"]["w"]


def make_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
