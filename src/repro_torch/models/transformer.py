"""The model (port of ``repro/models/transformer.py``): every family the
reference builds.

``Model(cfg)`` serves the dense family, its MLA mixer (``cfg.mla``,
minicpm3-4b: ``models/mla.py``) and its top-k MoE MLP (``cfg.moe``,
llama4-scout and mixtral: ``models/moe.py``), with full attention or a
sliding window (``cfg.sliding_window``, mixtral); the encoder-decoder family
(``encdec``, whisper: a non-causal encoder over frame embeddings plus
``pos``, and a decoder whose layers cross-attend its output after their
self-attention, ``ln_x`` / ``xattn``); the VLM family (``vlm``,
llama-3.2-vision: before every ``cross_attn_every`` decoder layers a
tanh-gated cross-attention block over ``patches @ vis_proj``, recomputed at
every use as the reference does); the SSM family (``ssm``, xlstm: mLSTM
blocks, ``models/ssm.py``, ``ln1`` and the mixer with no MLP); and the
hybrid family (``hybrid``, zamba2: Mamba2 blocks, with ONE weight-shared
attention + MLP block, ``shared_attn``, before each group of ``attn_every``
layers, its KV cache a group).  An SSM or hybrid config without an
``SSMConfig``, or with a MoE MLP or MLA, is refused.  It exposes:
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
    KV, dh), or MLA's latents c_kv and k_rope (L, B, max_seq, width), or
    the SSM carries (L, B, ...), the hybrid's shared k and v (G, B, max_seq,
    KV, dh) a group), written in place, its score rows through the GN
    softmax kernel (a sliding window keeps a ring of min(max_seq, window)
    slots); the decode step takes its position as a device tensor too, so
    one CUDA graph serves every step;
  * ``supports_paging`` / ``fresh_request_cache`` / ``insert_cache_slot`` /
    ``extract_cache_slot`` / ``prefill_chunk`` / ``fused_step_slots`` /
    ``decode_step_slots`` — the slab serving tick of the reference over a
    slot cache of ``init_cache(num_slots, max_seq)``, every slot at its own
    position, written in place by one layer loop (the reference vmaps its
    single-sequence step over the slots; a slot's MoE lanes route as a
    group of their own, as under that vmap; a slot's SSM carries freeze
    past its n_valid, and n_valid = 0 parks it);
  * ``init_paged_cache`` / ``fused_step_slots_paged`` / ``_paged_head`` —
    the block-paged serving tick over fp arenas, or int8 arenas with
    per-block f32 scales, its read named by ``paged_read_path``, and with
    ``sentinel`` the GN sentinels' per-layer and head probes.  The SSM and
    hybrid families do not page (their carries are O(1) a slot).

A request's side inputs live beside the KV as the cache's *extra* leaves
(``extra_leaves``, each with its slot axis): encdec's cross k and v
(``cross_k``/``cross_v``, (L, B, M, KV, dh), projected from the encoder's
output once) and the VLM's ``patches`` (B, P, D).  The static and slab
caches carry them in the same dict; the paged arenas do not (they have no
slot axis), so the paged tick takes them as ``extras`` (the pool's
slot-batched leaves, written at admission by ``insert_cache_slot_extras``).
The reference names them ``cross/{k,v}`` and ``patches`` in its cache tree;
it names the SSM carries ``layers/0..3`` (mLSTM: conv, C, n, m) or
``layers/0..1`` (Mamba2: conv, h) and the hybrid's ``shared/{k,v}``.

Each layer runs norm -> mixer -> norm -> MLP (or MoE), with encdec's
norm -> cross-attention between; an SSM or hybrid layer runs norm -> mixer
only, the hybrid's shared block norm -> attention -> norm -> MLP; the head
runs one more norm and the LM projection.  Every norm that follows a
residual add (ln2, and ln1 of every layer but the first) takes the add with
it in one fused launch (``apply_add_norm``): a layer's MLP (or SSM mixer)
output is carried into the next norm, and the last one is added before the
head.  Projections stay ``torch.matmul``, as the reference leaves them to
XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamSpec,
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
from repro_torch.parallel.sharding import (current_ctx, is_dtensor, local_kernel, local_mixer,
                                           shard, zeros)

# leaves the forward multiplies in the activation dtype (the reference casts
# each at its use: attention, MLA's latent projections, the MoE router and
# experts, the SSM mixers' projections, conv taps and gate bias; the mLSTM's
# wq/wk/wv are its block-diagonal (H, dh, dh) maps, cast alike); norms,
# MLA's latent gammas, Mamba2's a_log, dt_bias, d_skip and norm, and the
# embedding table stay f32 (rows are gathered first, then cast)
_MATMUL_LEAVES = {"wq", "wk", "wv", "wo", "wi", "wg", "w",
                  "wq_a", "wq_b", "wkv_a", "wkv_b", "router", "vis_proj",
                  "w_up", "w_down", "w_gate", "b_gate", "conv_w", "in_proj", "out_proj"}
# the hybrid's shared-attention KV leaves (G, B, max_seq, KV, dh), a group each
_SHARED_KV = {"shared_k": "k", "shared_v": "v"}


def _tree_map(fn, tree, key=None):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    return fn(key, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _split_layers(stacked: dict) -> list:
    """A stacked subtree (leading layer axis) as a list of per-layer trees
    of views: one unbind a leaf, so its backward stacks the layers'
    gradients once."""
    unbound = _tree_map(lambda _, t: t.unbind(0), stacked)
    n = len(next(_leaves(unbound)))
    return [_tree_map(lambda _, t, i=i: t[i], unbound) for i in range(n)]


class Model:
    def __init__(self, cfg: ModelConfig):
        if (cfg.family not in ("dense", "moe", "encdec", "vlm", "ssm", "hybrid")
                or (cfg.family == "moe") != (cfg.moe is not None)):
            raise NotImplementedError(
                f"{cfg.name}: only the dense family (with MLA or a top-k MoE MLP), the "
                f"encoder-decoder, VLM, SSM and hybrid families are ported (family "
                f"{cfg.family!r}, moe {cfg.moe is not None})")
        if cfg.family in ("ssm", "hybrid") and (cfg.ssm is None or cfg.mla is not None):
            raise NotImplementedError(f"{cfg.name}: the {cfg.family} family needs an SSMConfig "
                                      "and takes no MLA (no such config in the reference)")
        if cfg.family == "hybrid" and (cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not group by "
                             f"attn_every={cfg.attn_every}")
        if cfg.sliding_window and cfg.mla is not None:
            raise NotImplementedError(f"{cfg.name}: MLA with a sliding window has no "
                                      "counterpart in the reference")
        if cfg.family == "vlm" and (cfg.cross_attn_every < 1
                                    or cfg.n_layers % cfg.cross_attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not group by "
                             f"cross_attn_every={cfg.cross_attn_every}")
        self.cfg = cfg

    @property
    def _recurrent(self) -> bool:
        return self.cfg.family in ("ssm", "hybrid")

    @property
    def _ssm_block(self):
        """The mixer of an SSM or hybrid layer: the mLSTM for an ssm config
        of kind "mlstm", else Mamba2 (the hybrid's always)."""
        if self.cfg.family == "ssm" and self.cfg.ssm.kind == "mlstm":
            return ssm_mod.mlstm_block
        return ssm_mod.mamba2_block

    def _carry_specs(self, batch: int) -> dict:
        """One layer's carries, name -> (shape, dtype), in the reference's
        cache-tuple order."""
        if self._ssm_block is ssm_mod.mlstm_block:
            return ssm_mod.mlstm_cache_shape(self.cfg, batch)
        return ssm_mod.mamba2_cache_shape(self.cfg, batch)

    @property
    def carry_leaves(self) -> tuple:
        """The cache leaves a step updates from their own values (the SSM
        carries), which a warm-up before a graph capture must leave as it
        found them; empty for the KV families, whose steps write slots."""
        return tuple(self._carry_specs(1)) if self._recurrent else ()

    @property
    def extra_leaves(self) -> dict:
        """The cache's per-request side inputs, name -> slot axis."""
        if self.cfg.family == "encdec":
            return {"cross_k": 1, "cross_v": 1}
        if self.cfg.family == "vlm":
            return {"patches": 0}
        return {}

    def _attn_block_specs(self) -> dict:
        cfg = self.cfg
        return {"ln1": norm_specs(cfg), "attn": attn.attn_specs(cfg), "ln2": norm_specs(cfg),
                "mlp": mlp_specs(cfg)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        if self._recurrent:  # no separate MLP (d_ff folded in), as the reference
            mixer = (ssm_mod.mlstm_specs(cfg) if self._ssm_block is ssm_mod.mlstm_block
                     else ssm_mod.mamba2_specs(cfg))
            block = {"ln1": norm_specs(cfg), "mixer": mixer}
        else:
            mixer = mla_mod.mla_specs(cfg) if cfg.mla is not None else attn.attn_specs(cfg)
            block = {"ln1": norm_specs(cfg), "mixer": mixer, "ln2": norm_specs(cfg),
                     "mlp": moe_mod.moe_specs(cfg) if cfg.moe is not None else mlp_specs(cfg)}
        specs = {"embed": embed_specs(cfg)}
        if cfg.family == "encdec":
            block.update(ln_x=norm_specs(cfg), xattn=attn.cross_attn_specs(cfg))
            specs["encoder"] = {
                "layers": stack_specs(self._attn_block_specs(), cfg.encoder_layers),
                "pos": ParamSpec((cfg.encoder_seq, cfg.d_model), (None, "embed_fsdp")),
                "final_norm": norm_specs(cfg),
            }
        specs.update(layers=stack_specs(block, cfg.n_layers), final_norm=norm_specs(cfg),
                     lm_head=lm_head_specs(cfg))
        if cfg.family == "hybrid":
            specs["shared_attn"] = self._attn_block_specs()  # ONE shared block
        if cfg.family == "vlm":
            xblock = {"ln": norm_specs(cfg), "xattn": attn.cross_attn_specs(cfg),
                      "gate": ParamSpec((1,), (None,), init="zeros"),
                      "vis_proj": ParamSpec((cfg.d_model, cfg.d_model),
                                            ("embed_fsdp", None))}
            specs["xattn_layers"] = stack_specs(xblock, cfg.n_layers // cfg.cross_attn_every)
        return specs

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
        tree["layers"] = _split_layers(tree["layers"])
        if "encoder" in tree:
            tree["encoder"]["layers"] = _split_layers(tree["encoder"]["layers"])
        if "xattn_layers" in tree:
            tree["xattn_layers"] = _split_layers(tree["xattn_layers"])
        return tree

    def _embed(self, params, tokens):
        """Token rows of the f32 table, cast to the activation dtype (the
        reference casts the table first: the same values).  Under a sharding
        context over local shards: the table gathered whole, the rows of
        each rank's tokens."""
        dt = getattr(torch, self.cfg.dtype)
        return local_kernel(lambda tok, ids: tok[ids.long()].to(dt),
                            (params["embed"]["tok"], tokens), ((None, None), ("batch", None)),
                            ("batch", None, "embed_act"), like=1)

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

    def _xattn_block(self, xp, x, pending, patches):
        """The VLM's gated cross-attention block before a group of layers:
        (residual stream, tanh(gate) * cross-attention of ln(x) over
        ``patches @ vis_proj``, still to be added); the previous layer's
        ``pending`` MLP output added in by the fused norm."""
        cfg = self.cfg
        dt = x.dtype
        mem = patches.to(dt) @ xp["vis_proj"]
        if pending is None:
            h = apply_norm(cfg, xp["ln"], x)
        else:
            x, h = apply_add_norm(cfg, xp["ln"], x, pending)
        y = local_mixer(lambda h, mem, p: attn.cross_attention(cfg, p, h, mem), (h, mem),
                        xp["xattn"])
        return x, torch.tanh(xp["gate"].to(dt)) * y

    def _decoder(self, params, x, mixer, cross=None, patches=None, aux=None,
                 group_tokens: int = 0, shared=None):
        """The decoder stack over the embedded x; returns the residual stream
        before the head.  ``mixer(i, lp, h)`` is layer i's self-attention
        (or SSM mixer) output; encdec's ``cross(i, lp, hx)`` its
        cross-attention of ln_x(x); the VLM's ``patches`` the memory of the
        blocks before every ``cross_attn_every`` layers; the hybrid's
        ``shared(g, p, h)`` (read by the hybrid only) the shared block's
        attention output before group g.  A layer without an MLP (SSM, hybrid) carries its mixer output
        into the next norm.  ``aux`` and ``group_tokens`` as in
        ``_mlp_residual``."""
        cfg = self.cfg
        pending = None
        for i, lp in enumerate(params["layers"]):
            x = shard(x, "batch", "seq", "embed_act")
            if cfg.family == "vlm" and i % cfg.cross_attn_every == 0:
                x, pending = self._xattn_block(
                    params["xattn_layers"][i // cfg.cross_attn_every], x, pending, patches)
            if cfg.family == "hybrid" and i % cfg.attn_every == 0:
                sp = params["shared_attn"]
                x, h = self._ln1(sp, x, pending)
                x, pending = self._mlp_residual(sp, x, shared(i // cfg.attn_every,
                                                              sp["attn"], h))
            x, h = self._ln1(lp, x, pending)
            y = mixer(i, lp, h)
            if cross is not None:
                x, hx = apply_add_norm(cfg, lp["ln_x"], x, y)
                y = cross(i, lp, hx)
            if "mlp" in lp:
                x, pending = self._mlp_residual(lp, x, y, aux, group_tokens)
            else:
                pending = y
        return x + pending

    def _carried(self, p: dict, layer: dict, h, n_valid=None):
        """The SSM mixer ``p`` of a layer over its carries ``layer`` (views
        into a slab cache), the new carries written back in place (one
        graph keeps reading the same buffers): the mixer's output."""
        names = self.carry_leaves

        def fn(h, state, p):
            y, carry = self._ssm_block(self.cfg, p, h, tuple(state[n] for n in names), n_valid)
            for name, new in zip(names, carry):
                state[name].copy_(new)
            return y

        return _stateful_mixer(fn, h, {n: layer[n] for n in names}, p)

    def _encode(self, params, frames):
        """The whisper encoder over frame embeddings (B, M, D): ``pos``
        added, non-causal self-attention blocks (the GN flash kernel), the
        encoder's final norm.  Returns (B, M, D) in the activation dtype."""
        cfg = self.cfg
        enc = params["encoder"]
        dt = getattr(torch, cfg.dtype)
        frames = torch.as_tensor(frames).to(enc["pos"].device)
        x = frames.to(dt) + enc["pos"][None].to(dt)
        positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        pending = None
        for lp in enc["layers"]:
            x, h = self._ln1(lp, x, pending)
            y = attn.self_attention(cfg, lp["attn"], h, positions, causal=False)
            x, pending = self._mlp_residual(lp, x, y)
        return apply_add_norm(cfg, enc["final_norm"], x, pending)[1]

    def _memory(self, params, batch: dict):
        """The decoder's memory of a batch: the encoder's output of
        batch["frames"] (encdec), batch["patches"] (VLM), else None."""
        if self.cfg.family == "encdec":
            return self._encode(params, batch["frames"])
        if self.cfg.family == "vlm":
            return torch.as_tensor(batch["patches"]).to(params["embed"]["tok"].device)
        return None

    # --------------------------------------------------------- static path --
    def forward(self, params, batch: dict, aux: bool = False):
        """Teacher-forced logits (B, S, V) of batch["tokens"] (B, S), with
        batch["frames"] (B, M, D) for encdec and batch["patches"] (B, P, D)
        for the VLM; with ``aux`` the pair (logits, {"load_balance",
        "router_z"}), the MoE aux losses summed over the layers (0-d f32,
        zero without MoE), as the reference's ``forward`` returns them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = shard(self._embed(params, tokens), "batch", "seq", "embed_act")
        positions = torch.arange(tokens.shape[1], device=x.device).expand(tokens.shape)
        memory = self._memory(params, batch)
        if self._recurrent:
            def mixer(i, lp, h):
                return local_mixer(lambda h, p: self._ssm_block(cfg, p, h)[0], (h,),
                                   lp["mixer"])
        elif cfg.mla is not None:
            def mixer(i, lp, h):  # every row of positions is arange(S): a rank's are its own
                return local_mixer(lambda h, p: mla_mod.mla_self_attention(
                    cfg, p, h, positions[:h.shape[0]]), (h,), lp["mixer"])
        else:
            def mixer(i, lp, h):
                return attn.self_attention(cfg, lp["mixer"], h, positions)
        cross = None
        if cfg.family == "encdec":
            def cross(i, lp, hx):
                return local_mixer(lambda h, mem, p: attn.cross_attention(cfg, p, h, mem),
                                   (hx, memory), lp["xattn"])
        auxs = []
        x = self._decoder(params, x, mixer, cross, memory if cfg.family == "vlm" else None,
                          auxs, shared=lambda g, p, h: attn.self_attention(cfg, p, h, positions))
        logits = self._lm_head(params, x)
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
        if _vocab_split(logits):
            loss = _sharded_nll(logits, targets)
        else:
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
        width) per latent c_kv and k_rope, or the SSM carries (L, B, ...)
        (mLSTM conv, C, n, m; Mamba2 conv, h) and the hybrid's shared
        k and v (G, B, max_seq, KV, dh), a group each; then the extra leaves
        (``extra_specs``)."""
        cfg = self.cfg
        if self._recurrent:
            per_layer = self._carry_specs(batch)
        elif cfg.mla is not None:
            per_layer = mla_mod.mla_cache_shape(cfg, batch, max_seq)
        else:
            per_layer = attn.attn_cache_shape(cfg, batch, max_seq)
        specs = {k: ((cfg.n_layers, *shape), dt) for k, (shape, dt) in per_layer.items()}
        if cfg.family == "hybrid":
            groups = cfg.n_layers // cfg.attn_every
            kv = attn.attn_cache_shape(cfg, batch, max_seq)
            specs.update({name: ((groups, *kv[k][0]), kv[k][1]) for name, k in _SHARED_KV.items()})
        return {**specs, **self.extra_specs(batch)}

    def cache_logical_axes(self) -> dict:
        """Logical sharding axes of each ``cache_specs`` leaf (the
        reference's tree, flat): ``kv_seq`` switches to sequence
        parallelism for long-context decode (``SP_OVERRIDES``)."""
        cfg = self.cfg
        kv = ("layers", "batch", "kv_seq", "heads_tp", None)
        if cfg.mla is not None:
            axes = {k: ("layers", "batch", "kv_seq", None) for k in self.cache_specs(1, 1)}
        elif cfg.family == "ssm" and cfg.ssm.kind == "mlstm":
            axes = {"conv": ("layers", "batch", None, "ff"),
                    "C": ("layers", "batch", None, None, "heads_tp"),
                    "n": ("layers", "batch", None, "heads_tp"), "m": ("layers", "batch", None)}
        elif cfg.family in ("ssm", "hybrid"):
            axes = {"conv": ("layers", "batch", None, "ff"),
                    "h": ("layers", "batch", "heads_tp", None, None)}
        else:
            axes = {"k": kv, "v": kv}
        if cfg.family == "hybrid":
            axes.update({"shared_k": kv, "shared_v": kv})
        if cfg.family == "encdec":
            cross = ("layers", "batch", None, "heads_tp", None)
            axes.update({"cross_k": cross, "cross_v": cross})
        if cfg.family == "vlm":
            axes["patches"] = ("batch", None, None)
        return axes

    def extra_specs(self, batch: int) -> dict:
        """The extra leaves (``extra_leaves``), name -> (shape, dtype):
        encdec's cross k and v (L, B, encoder_seq, KV, dh), the VLM's
        patches (B, num_patches, D), in the activation dtype."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        if cfg.family == "encdec":
            kv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
            return {"cross_k": (kv, dt), "cross_v": (kv, dt)}
        if cfg.family == "vlm":
            return {"patches": ((batch, cfg.num_patches, cfg.d_model), dt)}
        return {}

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        """Zero slabs of ``cache_specs``; under a sharding context each a
        DTensor placed by ``cache_logical_axes``."""
        dev = resolve_device(device)
        axes = self.cache_logical_axes()
        return {k: zeros(shape, dt, dev, axes[k])
                for k, (shape, dt) in self.cache_specs(batch, max_seq).items()}

    def _per_layer(self, cache: dict, i: int) -> dict:
        """Layer i's view of a slab cache's KV leaves or carries (extras and
        the hybrid's shared KV, which is indexed by group, left out)."""
        return {name: leaf[i] for name, leaf in cache.items()
                if name not in self.extra_leaves and name not in _SHARED_KV}

    @staticmethod
    def _shared_kv(cache: dict, g: int) -> dict:
        """Group g's view of the hybrid's shared k and v slabs."""
        return {k: cache[name][g] for name, k in _SHARED_KV.items()}

    def _cross_fn(self, cache: dict):
        """encdec's cross-attention over the cached cross k and v of
        ``cache`` (a slab cache, or the paged pool's extras), else None."""
        if self.cfg.family != "encdec":
            return None
        cfg = self.cfg

        def cross(i, lp, hx):
            return attn.cross_attend_cached(cfg, lp["xattn"], hx, cache["cross_k"][i],
                                            cache["cross_v"][i])
        return cross

    def request_extras(self, params, extras: dict) -> dict:
        """A request's extra leaves, batch 1, from its ``extras`` (numpy or
        tensors without a batch axis): encdec's frames through the encoder
        and every layer's cross projection (``encode_cross_kv``), the
        VLM's patches cast to the activation dtype.  Empty for the other
        families."""
        dev = params["embed"]["tok"].device
        if self.cfg.family == "encdec":
            kv = self.encode_cross_kv(params, torch.as_tensor(extras["frames"])[None].to(dev))
            return {"cross_k": kv["k"], "cross_v": kv["v"]}
        if self.cfg.family == "vlm":
            dt = getattr(torch, self.cfg.dtype)
            return {"patches": torch.as_tensor(extras["patches"])[None].to(dev, dt)}
        return {}

    def encode_cross_kv(self, params, frames) -> dict:
        """encdec admission: the encoder over ``frames`` (B, M, D) once, then
        every layer's cross k and v, {"k", "v"}: (L, B, M, KV, dh), the
        layout of the cache's ``cross_k``/``cross_v`` (the reference's
        ``encode_cross_kv``)."""
        memory = self._encode(params, frames)
        ks, vs = zip(*(attn.project_cross_kv(self.cfg, lp["xattn"], memory)
                       for lp in params["layers"]))
        return {"k": torch.stack(ks), "v": torch.stack(vs)}

    def prefill(self, params, batch: dict, max_seq: int | None = None, cache: dict | None = None):
        """Prompt pass over batch["tokens"] (B, S) (and its frames or
        patches).  Returns the logits (B, S, V) of every position and a slab
        cache of ``max_seq`` (default S) slots holding the prompt's K/V at
        [0, S) and zeros past it (a sliding window's ring: the last
        ``window`` positions, position p in slot p % window, as the
        reference rolls them), and the batch's extra leaves: a new one, or
        ``cache`` (``init_cache(B, max_seq)``'s shapes) zeroed and written in
        place, so a captured decode step can keep reading it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = shard(self._embed(params, tokens), "batch", None, "embed_act")
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
        memory = self._memory(params, batch)
        if cfg.family == "encdec":
            for i, lp in enumerate(params["layers"]):
                k, v = attn.project_cross_kv(cfg, lp["xattn"], memory)
                cache["cross_k"][i].copy_(k)
                cache["cross_v"][i].copy_(v)
        elif cfg.family == "vlm":
            cache["patches"].copy_(memory)
        prefill = mla_mod.mla_prefill if cfg.mla is not None else attn.attn_prefill
        win = cfg.sliding_window or 0

        def write_kv(layer: dict, kv: dict) -> None:
            for name, new in kv.items():
                if win and s > win:  # the ring: position p in slot p % window
                    layer[name].copy_(torch.roll(new, s % win, dims=1))
                elif s == layer[name].shape[1]:  # the whole slab (a sharded one too)
                    layer[name].copy_(new)
                elif is_dtensor(layer[name]):
                    raise NotImplementedError(
                        f"a prefill of {s} tokens into a sharded slab of {layer[name].shape[1]}: "
                        "under a sharding context the prefill fills its whole slab")
                else:
                    layer[name][:, :s] = new

        def mixer(i, lp, h):
            if self._recurrent:  # the monolithic serving call: exact
                names = self.carry_leaves
                y, *carry = local_mixer(
                    lambda h, p: _flat(self._ssm_block(cfg, p, h, exact=True)), (h,),
                    lp["mixer"], n_out=1 + len(names))
                for name, new in zip(names, carry):
                    cache[name][i].copy_(new)
                return y
            if cfg.mla is not None:  # whole on each rank's rows under a context
                y, c_kv, k_rope = local_mixer(
                    lambda h, pos, p: _flat(prefill(cfg, p, h, pos)), (h, positions),
                    lp["mixer"], n_out=3)
                kv = {"c_kv": c_kv, "k_rope": k_rope}
            else:
                y, kv = prefill(cfg, lp["mixer"], h, positions)
            write_kv(self._per_layer(cache, i), kv)
            return y

        def shared(g, p, h):
            y, kv = attn.attn_prefill(cfg, p, h, positions)
            write_kv(self._shared_kv(cache, g), kv)
            return y

        x = self._decoder(params, x, mixer, self._cross_fn(cache), cache.get("patches"),
                          shared=shared)
        return self._lm_head(params, x), cache

    def decode_step(self, params, cache, token, pos):
        """token: (B, 1) at position ``pos``: a Python int, or a 0-d int32
        tensor on the cache's device (one CUDA graph then serves every
        position).  Writes slot ``pos`` of every layer's slabs in place
        (reading the extra leaves ``prefill`` wrote); returns (logits
        (B, 1, V), cache)."""
        cfg = self.cfg
        x = shard(self._embed(params, token), "batch", None, "embed_act")
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=x.device)
        step = mla_mod.mla_decode_step if cfg.mla is not None else attn.attn_decode_step

        def mixer(i, lp, h):
            layer = self._per_layer(cache, i)
            if self._recurrent:
                return self._carried(lp["mixer"], layer, h)
            if cfg.mla is not None:  # whole on each rank's rows under a context
                return _stateful_mixer(lambda h, state, p: step(cfg, p, state, h, pos)[0], h,
                                       layer, lp["mixer"])
            return step(cfg, lp["mixer"], layer, h, pos)[0]

        x = self._decoder(
            params, x, mixer, self._cross_fn(cache), cache.get("patches"),
            shared=lambda g, p, h: attn.attn_decode_step(cfg, p, self._shared_kv(cache, g), h,
                                                         pos)[0])
        return self._lm_head(params, x), cache

    # ----------------------------------------------------------- slab tick --
    @property
    def supports_paging(self) -> bool:
        """Whether the KV pages into blocks (the reference's rule): the full
        attention KV and MLA's latents do; a sliding window keeps its ring
        in the slab pool, and the SSM and hybrid carries are O(1) state a
        slot (the hybrid's shared KV rides beside them in the slab)."""
        return self.cfg.sliding_window == 0 and not self._recurrent

    def fresh_request_cache(self, max_seq: int, device=None) -> dict:
        """A batch-1 cache in its state before a prompt, which admission
        pages into a slab slot (with the request's extra leaves put over the
        zero ones): zeros, but for the mLSTM stabilizer m at -1e30 (the
        reference's carry=None start; a zero m would corrupt the first
        chunk's gating)."""
        cache = self.init_cache(1, max_seq, device)
        if "m" in self.carry_leaves:
            cache["m"].fill_(-1e30)
        return cache

    def insert_cache_slot(self, pool_cache: dict, request_cache: dict, slot: int) -> dict:
        """Copy a batch-1 cache into row ``slot`` of every leaf of a slot
        cache (batch axis 1, the VLM's patches 0), in place; returns
        ``pool_cache``."""
        for name, leaf in pool_cache.items():
            ax = self.extra_leaves.get(name, 1)
            leaf.select(ax, slot).copy_(request_cache[name].select(ax, 0))
        return pool_cache

    def extract_cache_slot(self, pool_cache: dict, slot: int) -> dict:
        """Row ``slot`` of a slot cache as a batch-1 copy."""
        return {name: leaf.narrow(self.extra_leaves.get(name, 1), slot, 1).clone()
                for name, leaf in pool_cache.items()}

    def _slab_pass(self, params, cache, tokens, positions, n_valid, decode: bool,
                   group_tokens: int):
        """The layers over a slot cache: tokens (N, C) at positions[s] + i,
        lanes i < n_valid[s] written; ``decode`` (C = 1) takes the
        reference's decode step, else its chunk.  Returns the residual
        stream (N, C, D) before the head."""
        cfg = self.cfg

        def attend(p, layer, h):
            if decode:
                return attn.attn_slab_decode(cfg, p, layer, h, positions, n_valid > 0)
            return attn.attn_slab_chunk(cfg, p, layer, h, positions, n_valid)

        def mixer(i, lp, h):
            layer = self._per_layer(cache, i)
            if self._recurrent:  # a decode lane is n_valid 1 (live) or 0 (parked)
                return self._carried(lp["mixer"], layer, h, n_valid)
            if cfg.mla is not None:
                return mla_mod.mla_slab_chunk(cfg, lp["mixer"], layer, h, positions, n_valid)
            return attend(lp["mixer"], layer, h)

        return self._decoder(params, self._embed(params, tokens), mixer, self._cross_fn(cache),
                             cache.get("patches"), group_tokens=group_tokens,
                             shared=lambda g, p, h: attend(p, self._shared_kv(cache, g), h))

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
            raise ValueError(f"{self.cfg.name} (family {self.cfg.family!r}, sliding_window="
                             f"{self.cfg.sliding_window}) has no pageable KV")
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

    def init_paged_extras(self, num_slots: int, device=None) -> dict:
        """The paged pool's slot-batched extra leaves (``extra_specs``),
        zeroed: the paged tick's ``extras``, written at admission."""
        dev = resolve_device(device)
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in self.extra_specs(num_slots).items()}

    def insert_cache_slot_extras(self, pool_extras: dict, request_extras: dict,
                                 slot: int) -> dict:
        """Admission over the paged pool: copy a request's batch-1 extra
        leaves into row ``slot`` of the pool's, in place (the block arenas
        have no slot axis: the prompt streams into them through the block
        table)."""
        return self.insert_cache_slot(pool_extras, request_extras, slot)

    def fused_step_slots_paged(self, params, cache, tokens, positions, n_valid, tables,
                               sentinel: bool = False, extras: dict | None = None):
        """One paged serving tick: every slot processes its own C-token chunk
        at its own write offset.  params: ``prepare``d; tokens: (N, C) int;
        positions/n_valid: (N,) int32 (n_valid = 0 parks a lane: no writes);
        tables: (N, max_bt) int32; ``extras``: the pool's slot-batched extra
        leaves (``init_paged_extras``; encdec and VLM).  Writes the arenas of
        ``cache`` (and its scales, for int8 arenas) in place and returns the
        logits (N, 1, V) of each slot's row n_valid - 1.  With ``sentinel``
        it also returns the GN sentinels' health, as the reference's:
        {"layers": (L, N, 3) f32, one ``attention.paged_probe_word`` a layer
        (of its self-attention read), "head": (N,) f32, the final norm's σ
        residual (``_paged_head``)}, computed on the device."""
        cfg = self.cfg
        extras = extras or {}
        a, b = self._arena_rows
        chunk = mla_mod.mla_paged_chunk if cfg.mla is not None else attn.attn_paged_chunk
        all_scales = (cache[f"{a}_scale"], cache[f"{b}_scale"]) if f"{a}_scale" in cache else None
        probes = []

        def mixer(i, lp, h):
            sc = None if all_scales is None else (all_scales[0][i], all_scales[1][i])
            y = chunk(cfg, lp["mixer"], cache[a][i], cache[b][i], h, positions, n_valid, tables,
                      sc, probe=sentinel)
            if sentinel:
                y, pr = y
                probes.append(pr)
            return y

        x = shard(self._embed(params, tokens), "batch", None, "embed_act")
        x = self._decoder(params, x, mixer, self._cross_fn(extras),
                          extras.get("patches"))
        if not sentinel:
            return self._paged_head(params, x, n_valid)
        logits, head = self._paged_head(params, x, n_valid, probe=True)
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
        logits = apply_norm(self.cfg, params["final_norm"], x) @ params["lm_head"]["w"]
        return shard(logits, "batch", "seq", "vocab")


def _flat(out) -> tuple:
    """A mixer's (y, state) as one flat tuple: y, then the state's tensors
    (a tuple of carries, or a dict of K/V leaves in its order)."""
    y, state = out
    return (y, *(state.values() if isinstance(state, dict) else state))


def _stateful_mixer(fn, h, state: dict, p: dict):
    """``fn(h, state, p)``, a mixer that writes the tensors of ``state`` in
    place, through ``local_mixer``: under a sharding context each rank runs
    it whole on its rows of h and of the state (the state gathered along
    its other dims), and the state it wrote goes back into the state's
    shards; without one, ``fn`` itself, writing ``state`` in place."""
    names = list(state)

    def body(h, *rest):
        local = dict(zip(names, rest[:-1]))
        y = fn(h, local, rest[-1])
        return (y, *(local[n] for n in names))

    y, *new = local_mixer(body, (h, *state.values()), p, n_out=1 + len(names))
    for name, value in zip(names, new):
        if value is not state[name]:
            state[name].copy_(value)
    return y


def _vocab_split(logits) -> bool:
    """Whether ``logits`` is a DTensor whose vocab (last) dim a mesh axis of
    more than one rank splits."""
    if not is_dtensor(logits):
        return False
    from torch.distributed.tensor import Shard

    last = logits.dim() - 1
    return any(isinstance(p, Shard) and p.dim == last and logits.device_mesh.size(i) > 1
               for i, p in enumerate(logits.placements))


def _sharded_nll(logits, targets):
    """The mean next-token NLL of f32 ``logits`` (B, S, V) DTensors whose
    vocab dim a mesh axis may split: the log-sum-exp over the vocab and the
    target's logit picked by a compare against vocab ids placed as the
    logits' vocab dim, so that no rank gathers the whole vocab (a
    ``gather`` along a split dim would replicate the logits on every
    rank).  The same quantity as ``Model.loss``'s unsharded form."""
    from torch.distributed.tensor import distribute_tensor

    ctx = current_ctx()
    v = logits.shape[-1]
    ids = distribute_tensor(torch.arange(v, device=logits.device), ctx.mesh,
                            ctx.placements((v,), ("vocab",)), src_data_rank=None)
    rows = ("batch", "seq")  # each row's reductions whole on the ranks of its batch shard
    m = shard(logits.detach().amax(dim=-1), *rows)
    lse = shard((logits - m[..., None]).exp().sum(dim=-1), *rows).log() + m
    picked = shard(torch.where(ids == targets[..., None], logits, 0.0).sum(dim=-1), *rows)
    return (lse - picked).mean()


def make_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
