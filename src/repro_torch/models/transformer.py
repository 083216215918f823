"""Decoder-only model (port of the dense, MLA and MoE paths of
``repro/models/transformer.py``).

``Model(cfg)`` serves the dense family, its MLA mixer (``cfg.mla``,
minicpm3-4b: ``models/mla.py``) and its top-k MoE MLP (``cfg.moe``,
llama4-scout and mixtral: ``models/moe.py``), with full attention or a
sliding window (``cfg.sliding_window``, mixtral); every other family (SSM,
hybrid, encoder-decoder, VLM) is refused.  It exposes:
  * ``param_specs()`` / ``init(seed, device)`` — the reference's parameter
    tree (stacked ``layers``), f32 masters, drawn from a ``torch.Generator``;
  * ``prepare(params, device)``                 — the tree the forward runs on:
    moved to the device, the matmul weights cast once to ``cfg.dtype``
    (what the reference's ``.astype(dt)`` at every einsum computes), and
    ``layers`` split into a per-layer list of views; differentiable, so a
    training step runs it on f32 masters that require grad (the
    reference's ``_cast_for_compute``) and the gradients reach them;
  * ``forward``                                 — teacher-forced logits over
    every position (with ``aux=True`` also the reference's MoE aux sums),
    self-attention through the GN flash-attention kernel (or the one-pass
    exact softmax; MLA one-pass); ``loss`` — the mean next-token NLL, plus
    the reference's MoE terms;
  * ``cache_specs`` / ``init_cache`` / ``prefill`` / ``decode_step`` — the
    static path over a slab cache per layer leaf (k and v (L, B, max_seq,
    KV, dh), or MLA's latents c_kv and k_rope (L, B, max_seq, width)),
    written in place, its score rows through the GN softmax kernel (a
    sliding window keeps a ring of min(max_seq, window) slots); the
    decode step takes its position as a device tensor too, so one CUDA
    graph serves every step;
  * ``supports_paging`` / ``fresh_request_cache`` / ``insert_cache_slot`` /
    ``extract_cache_slot`` / ``prefill_chunk`` / ``fused_step_slots`` /
    ``decode_step_slots`` — the slab serving tick of the reference over a
    slot cache of ``init_cache(num_slots, max_seq)``, every slot at its own
    position, written in place by one layer loop (the reference vmaps its
    single-sequence step over the slots; a slot's MoE lanes route as a
    group of their own, as under that vmap);
  * ``init_paged_cache`` / ``fused_step_slots_paged`` / ``_paged_head`` —
    the block-paged serving tick over fp arenas, or int8 arenas with
    per-block f32 scales, its read named by ``paged_read_path``, and with
    ``sentinel`` the GN sentinels' per-layer and head probes.

Each layer runs norm -> mixer -> norm -> MLP (or MoE); the head runs one
more norm and the LM projection.  Every norm that follows a residual add
(ln2, and ln1 of every layer but the first) takes the add with it in one
fused launch (``apply_add_norm``): a layer's MLP output is carried into the
next layer's ln1, and the last one is added before the head.  Projections
stay ``torch.matmul``, as the reference leaves them to XLA outside any
Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
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

# leaves the forward multiplies in the activation dtype (the reference casts
# each at its use: attention, MLA's latent projections, the MoE router and
# experts); norms, MLA's latent gammas and the embedding table stay f32
# (rows are gathered first, then cast)
_MATMUL_LEAVES = {"wq", "wk", "wv", "wo", "wi", "wg", "w",
                  "wq_a", "wq_b", "wkv_a", "wkv_b", "router"}


def _tree_map(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


class Model:
    def __init__(self, cfg: ModelConfig):
        if (cfg.family, cfg.moe is None) not in (("dense", True), ("moe", False)):
            raise NotImplementedError(
                f"{cfg.name}: only the dense family, with MLA or a top-k MoE MLP, is ported "
                f"(family {cfg.family!r})")
        if cfg.sliding_window and cfg.mla is not None:
            raise NotImplementedError(f"{cfg.name}: MLA with a sliding window has no "
                                      "counterpart in the reference")
        self.cfg = cfg

    def param_specs(self) -> dict:
        cfg = self.cfg
        mixer = mla_mod.mla_specs(cfg) if cfg.mla is not None else attn.attn_specs(cfg)
        block = {"ln1": norm_specs(cfg), "mixer": mixer, "ln2": norm_specs(cfg),
                 "mlp": moe_mod.moe_specs(cfg) if cfg.moe is not None else mlp_specs(cfg)}
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

    def _mlp_residual(self, lp, x, y, aux=None, group_tokens: int = 0):
        """Adds the mixer output y to the residual stream x, then ln2 and the
        MLP or MoE: (residual stream, its output still to be added).  A
        list ``aux`` collects each MoE layer's aux dict; ``group_tokens`` is
        the MoE's routing run (``moe.route``)."""
        x, h = apply_add_norm(self.cfg, lp["ln2"], x, y)
        if self.cfg.moe is None:
            return x, apply_mlp(self.cfg, lp["mlp"], h)
        y, layer_aux = moe_mod.apply_moe(self.cfg, lp["mlp"], h, group_tokens)
        if aux is not None:
            aux.append(layer_aux)
        return x, y

    # --------------------------------------------------------- static path --
    def forward(self, params, batch: dict, aux: bool = False):
        """Teacher-forced logits (B, S, V) of batch["tokens"] (B, S); with
        ``aux`` the pair (logits, {"load_balance", "router_z"}), the MoE aux
        losses summed over the layers (0-d f32, zero without MoE), as the
        reference's ``forward`` returns them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device).expand(tokens.shape)
        pending, auxs = None, []
        for lp in params["layers"]:
            x, h = self._ln1(lp, x, pending)
            if cfg.mla is not None:
                y = mla_mod.mla_self_attention(cfg, lp["mixer"], h, positions)
            else:
                y = attn.self_attention(cfg, lp["mixer"], h, positions)
            x, pending = self._mlp_residual(lp, x, y, auxs)
        logits = self._lm_head(params, x + pending)
        if not aux:
            return logits
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, {key: sum((a[key] for a in auxs), zero)
                        for key in ("load_balance", "router_z")}

    def loss(self, params, batch: dict):
        """(loss, metrics) of batch["tokens"] (B, S): the mean next-token NLL
        from the f32 log-softmax of the shifted logits, plus for MoE the
        reference's 0.01 * load_balance / L + 1e-3 * router_z / L (its aux
        then in the metrics), as the reference's ``Model.loss``.
        Differentiable through ``prepare`` back to f32 masters."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch, aux=True)
        logits = logits.float()[:, :-1]
        targets = torch.as_tensor(batch["tokens"]).to(logits.device)[:, 1:].long()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
        metrics = {"nll": loss}
        if cfg.moe is not None:
            loss = loss + 0.01 * aux["load_balance"] / cfg.n_layers
            loss = loss + 1e-3 * aux["router_z"] / cfg.n_layers
            metrics.update(aux)
        return loss, metrics

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        """The static path's slab cache, name -> (shape, dtype):
        (L, B, max_seq, KV, dh) per k and v, or for MLA (L, B, max_seq,
        width) per latent c_kv and k_rope."""
        if self.cfg.mla is not None:
            per_layer = mla_mod.mla_cache_shape(self.cfg, batch, max_seq)
        else:
            per_layer = attn.attn_cache_shape(self.cfg, batch, max_seq)
        return {k: ((self.cfg.n_layers, *shape), dt) for k, (shape, dt) in per_layer.items()}

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        dev = resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in self.cache_specs(batch, max_seq).items()}

    def prefill(self, params, batch: dict, max_seq: int | None = None, cache: dict | None = None):
        """Prompt pass over batch["tokens"] (B, S).  Returns the logits
        (B, S, V) of every position and a slab cache of ``max_seq`` (default
        S) slots holding the prompt's K/V at [0, S) and zeros past it (a
        sliding window's ring: the last ``window`` positions, position p in
        slot p % window, as the reference rolls them): a new one, or
        ``cache`` (``init_cache(B, max_seq)``'s shapes) zeroed and written in
        place, so a captured decode step can keep reading it."""
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
        prefill = mla_mod.mla_prefill if cfg.mla is not None else attn.attn_prefill
        win = cfg.sliding_window or 0
        pending = None
        for i, lp in enumerate(params["layers"]):
            x, h = self._ln1(lp, x, pending)
            y, kv = prefill(cfg, lp["mixer"], h, positions)
            for name, new in kv.items():
                if win and s > win:  # the ring: position p in slot p % window
                    cache[name][i].copy_(torch.roll(new, s % win, dims=1))
                else:
                    cache[name][i, :, :s] = new
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
        step = mla_mod.mla_decode_step if cfg.mla is not None else attn.attn_decode_step
        for i, lp in enumerate(params["layers"]):
            x, h = self._ln1(lp, x, pending)
            y, _ = step(cfg, lp["mixer"], {name: slab[i] for name, slab in cache.items()}, h, pos)
            x, pending = self._mlp_residual(lp, x, y)
        return self._lm_head(params, x + pending), cache

    # ----------------------------------------------------------- slab tick --
    @property
    def supports_paging(self) -> bool:
        """Whether the KV pages into blocks (the reference's rule): the full
        attention KV and MLA's latents do; a sliding window keeps its ring
        in the slab pool."""
        return self.cfg.sliding_window == 0

    def fresh_request_cache(self, max_seq: int, device=None) -> dict:
        """A batch-1 cache in its state before a prompt (zeros), which
        admission pages into a slab slot."""
        return self.init_cache(1, max_seq, device)

    @staticmethod
    def insert_cache_slot(pool_cache: dict, request_cache: dict, slot: int) -> dict:
        """Copy a batch-1 cache into row ``slot`` of every leaf of a slot
        cache (batch axis 1), in place; returns ``pool_cache``."""
        for name, leaf in pool_cache.items():
            leaf[:, slot].copy_(request_cache[name][:, 0])
        return pool_cache

    @staticmethod
    def extract_cache_slot(pool_cache: dict, slot: int) -> dict:
        """Row ``slot`` of a slot cache as a batch-1 copy."""
        return {name: leaf[:, slot:slot + 1].clone() for name, leaf in pool_cache.items()}

    def _slab_pass(self, params, cache, tokens, positions, n_valid, decode: bool,
                   group_tokens: int):
        """The layers over a slot cache: tokens (N, C) at positions[s] + i,
        lanes i < n_valid[s] written; ``decode`` (C = 1) takes the
        reference's decode step, else its chunk.  Returns the residual
        stream (N, C, D) before the head."""
        cfg = self.cfg
        x, pending = self._embed(params, tokens), None
        for i, lp in enumerate(params["layers"]):
            x, h = self._ln1(lp, x, pending)
            layer = {name: slab[i] for name, slab in cache.items()}
            if cfg.mla is not None:
                y = mla_mod.mla_slab_chunk(cfg, lp["mixer"], layer, h, positions, n_valid)
            elif decode:
                y = attn.attn_slab_decode(cfg, lp["mixer"], layer, h, positions, n_valid > 0)
            else:
                y = attn.attn_slab_chunk(cfg, lp["mixer"], layer, h, positions, n_valid)
            x, pending = self._mlp_residual(lp, x, y, group_tokens=group_tokens)
        return x + pending

    def prefill_chunk(self, params, cache, tokens, pos, n_valid, last_only: bool = False):
        """The reference's masked, position-offset multi-token step: tokens
        (B, C) at positions [pos, pos + n_valid) of every row (``pos`` and
        ``n_valid`` ints or 0-d tensors), appended to ``cache`` in place.
        Returns the logits (B, C, V), or with ``last_only`` those of row
        n_valid - 1 (B, 1, V)."""
        b = tokens.shape[0]
        dev = tokens.device
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(b)
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).expand(b)
        x = self._slab_pass(params, cache, tokens, pos, nv, decode=False, group_tokens=0)
        if last_only:
            return self._paged_head(params, x, nv), cache
        return self._lm_head(params, x), cache

    def fused_step_slots(self, params, cache, tokens, positions, n_valid):
        """The slab fused tick: every slot takes its own C-token chunk at its
        own position.  tokens: (N, C) int; positions/n_valid: (N,) int32
        (n_valid = 0 parks a slot: it writes nothing).  Writes ``cache`` in
        place; returns the logits (N, 1, V) of each slot's row n_valid - 1."""
        x = self._slab_pass(params, cache, tokens, positions, n_valid, decode=False,
                            group_tokens=tokens.shape[1])
        return self._paged_head(params, x, n_valid)

    def decode_step_slots(self, params, cache, tokens, positions, live=None):
        """The slab decode tick: tokens (N, 1) at positions (N,) int32, the
        reference's decode step per slot; ``live`` (N,) bool, default all,
        parks the others (no writes).  Writes ``cache`` in place; returns the
        logits (N, 1, V)."""
        if live is None:
            live = torch.ones_like(positions, dtype=torch.bool)
        x = self._slab_pass(params, cache, tokens, positions, live.to(torch.int32),
                            decode=True, group_tokens=1)
        return self._lm_head(params, x)

    # ---------------------------------------------------------- paged tick --
    @property
    def paged_read_path(self) -> str:
        """The paged read the serving tick takes: ``"kernel"`` (the GN
        paged-attention kernel), or the reference's ``"streamed"`` or
        ``"gathered"`` read when ``attention.FORCE_PAGED_READ`` forces one.
        The engine fixes it at construction and reports it in ``metrics()``.
        MLA takes its own rule (``mla.mla_paged_read_path``: streamed, there
        is no MLA kernel)."""
        if self.cfg.mla is not None:
            return mla_mod.mla_paged_read_path(self.cfg)
        return attn.paged_read_path(self.cfg)

    @property
    def _arena_rows(self) -> dict:
        """The paged arenas' leaves, in the order the mixer takes them, each
        with its row shape (one token's entry in a block)."""
        cfg = self.cfg
        if cfg.mla is not None:
            return {"c_kv": (cfg.mla.kv_lora_rank,), "k_rope": (cfg.mla.qk_rope_head_dim,)}
        return {"k": (cfg.n_kv_heads, cfg.head_dim), "v": (cfg.n_kv_heads, cfg.head_dim)}

    def init_paged_cache(self, num_blocks: int, block_size: int, device=None,
                         kv_dtype: str = "fp") -> dict:
        """Block arenas (L, num_blocks + 1, block_size, ...): "k", "v" with
        (KV, dh) a row, or MLA's "c_kv" (kv_lora_rank) and "k_rope"
        (qk_rope_head_dim); the extra block is the write sink of
        ``attention.paged_write_indices``.  ``kv_dtype="int8"`` stores the
        arenas in int8 and adds "<leaf>_scale" (L, num_blocks + 1) f32 a
        leaf, zeroed: the per-block dequant scales (the reference's
        ``<leaf>_scale`` leaves), block axis at 1 like the arenas."""
        if not self.supports_paging:
            raise ValueError(f"{self.cfg.name} (sliding_window={self.cfg.sliding_window}) "
                             "has no pageable KV")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        cfg, rows = self.cfg, self._arena_rows
        lead = (cfg.n_layers, num_blocks + 1, block_size)
        dt = torch.int8 if kv_dtype == "int8" else getattr(torch, cfg.dtype)
        dev = resolve_device(device)
        cache = {k: torch.zeros(lead + row, dtype=dt, device=dev) for k, row in rows.items()}
        if kv_dtype == "int8":
            for key in rows:
                cache[f"{key}_scale"] = torch.zeros(lead[:2], dtype=torch.float32, device=dev)
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
        a, b = self._arena_rows
        chunk = mla_mod.mla_paged_chunk if cfg.mla is not None else attn.attn_paged_chunk
        all_scales = (cache[f"{a}_scale"], cache[f"{b}_scale"]) if f"{a}_scale" in cache else None
        scales = zip(*all_scales) if all_scales else [None] * cfg.n_layers
        probes = []
        for lp, arena_a, arena_b, sc in zip(params["layers"], cache[a], cache[b], scales):
            x, h = self._ln1(lp, x, pending)
            y = chunk(cfg, lp["mixer"], arena_a, arena_b, h, positions, n_valid, tables, sc,
                      probe=sentinel)
            if sentinel:
                y, pr = y
                probes.append(pr)
            x, pending = self._mlp_residual(lp, x, y)
        if not sentinel:
            return self._paged_head(params, x + pending, n_valid)
        logits, head = self._paged_head(params, x + pending, n_valid, probe=True)
        words = attn.paged_probe_word(probes, positions, n_valid, tables, cache[a].shape[2],
                                      all_scales)
        return logits, {"layers": words, "head": head}

    def _paged_head(self, params, x, n_valid, probe: bool = False):
        """Next-token logits per slot (of the paged and the slab tick):
        gather row n_valid - 1 (clamped for parked lanes), then project only
        that row.  With ``probe`` also the
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
