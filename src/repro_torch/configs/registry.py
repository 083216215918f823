"""Architecture registry of the port: the dense configs it can serve.

Each entry is copied from ``repro/configs/registry.py``; ``reduce_config``
is the reference's systematic shrink for CPU tests, copied as it is.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


DEEPSEEK_CODER_33B = register(ModelConfig(
    name="deepseek-coder-33b", family="dense",
    microbatches=16,
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256, norm_impl="gn_rms", rope_theta=100000.0,
))

INTERNLM2_1_8B = register(ModelConfig(
    name="internlm2-1.8b", family="dense",
    microbatches=2,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92544, norm_impl="gn_rms", rope_theta=1000000.0,
))

STABLELM_1_6B = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    microbatches=2,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, norm_impl="gn_ln",
))

GPT_NEO_1_3B = register(ModelConfig(
    name="gpt-neo-1.3b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50257, norm_impl="gn_ln", mlp_act="gelu",
))


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Systematically shrink a config for CPU smoke tests (same family/code)."""
    small: dict = dict(
        n_layers=max(2, (cfg.attn_every or 2) if cfg.family == "hybrid" else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.family == "encdec" else cfg.encoder_seq,
        num_patches=8 if cfg.family == "vlm" else cfg.num_patches,
        attn_every=2 if cfg.family == "hybrid" else cfg.attn_every,
        cross_attn_every=2 if cfg.family == "vlm" else cfg.cross_attn_every,
        sliding_window=8 if cfg.sliding_window else 0,
        remat="none",
        microbatches=1,
    )
    if cfg.family == "hybrid":
        small["n_layers"] = 4
    if cfg.family == "vlm":
        small["n_layers"] = 4
    if cfg.moe is not None:
        small["moe"] = MoEConfig(num_experts=4, top_k=cfg.moe.top_k, group_size=64)
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        small["head_dim"] = 24
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(kind=cfg.ssm.kind, state_dim=8,
                                 head_dim=16, expand=2, conv_dim=4)
        if cfg.ssm.kind == "mlstm":
            small["n_heads"] = 2
            small["head_dim"] = 64
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
