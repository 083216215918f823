"""Architecture registry of the port: the configs it can serve (dense, the
MLA latent-attention one, the top-k MoE ones, mixtral's with a sliding
window, the mLSTM one, the Mamba2 hybrid with its shared attention block,
the encoder-decoder whisper and the cross-attending VLM): all twelve of the
reference's.

Each entry is copied from ``repro/configs/registry.py``; ``reduce_config``
is the reference's systematic shrink for CPU tests, copied as it is.
``ASSIGNED_ARCHS``, ``input_specs`` and ``input_logical_axes`` are the
multi-pod dry run's inputs (``launch/dryrun.py``): shapes only, each leaf a
``(shape, dtype)`` pair as ``Model.cache_specs`` gives its leaves, so
nothing is allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig

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


WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3", family="encdec",
    microbatches=4,
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, mlp_act="gelu", norm_impl="gn_ln",
    encoder_layers=32, encoder_seq=1500,
))

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

MINICPM3_4B = register(ModelConfig(
    name="minicpm3-4b", family="dense",
    microbatches=8,
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, norm_impl="gn_rms",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    head_dim=96,  # qk_nope + qk_rope
))

STABLELM_1_6B = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    microbatches=2,
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, norm_impl="gn_ln",
))

LLAMA4_SCOUT = register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    microbatches=8,
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, norm_impl="gn_rms", rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1),
))

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    microbatches=16, opt_state_dtype="bfloat16",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, norm_impl="gn_rms", sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
))

XLSTM_350M = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    microbatches=8,
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, norm_impl="gn_ln",
    ssm=SSMConfig(kind="mlstm", expand=2, conv_dim=4),
    head_dim=256,
))

ZAMBA2_7B = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    microbatches=16,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, norm_impl="gn_rms",
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2, conv_dim=4),
    attn_every=9,  # 81 = 9 groups x 9 layers; a shared attention block a group
))

LLAMA32_VISION_11B = register(ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    microbatches=16,
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, norm_impl="gn_rms", rope_theta=500000.0,
    cross_attn_every=5, num_patches=1601,
))

GPT_NEO_1_3B = register(ModelConfig(
    name="gpt-neo-1.3b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50257, norm_impl="gn_ln", mlp_act="gelu",
))

BERT_BASE = register(ModelConfig(
    name="bert-base", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=30522, norm_impl="gn_ln", mlp_act="gelu",
))

ASSIGNED_ARCHS = (
    "whisper-large-v3", "deepseek-coder-33b", "internlm2-1.8b", "minicpm3-4b",
    "stablelm-1.6b", "llama4-scout-17b-a16e", "mixtral-8x22b", "xlstm-350m",
    "zamba2-7b", "llama-3.2-vision-11b",
)


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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``(shape, dtype)`` stand-ins for every model input of the given shape.

    train/prefill: the token batch (and the modality stubs).  decode: one
    new token, the cache of seq_len (``Model.cache_specs``) and the
    position scalar.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((b, s), i32)}
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model), getattr(torch, cfg.dtype))
        if cfg.family == "vlm":
            specs["patches"] = ((b, cfg.num_patches, cfg.d_model), getattr(torch, cfg.dtype))
        return specs
    from repro_torch.models.transformer import make_model

    return {"token": ((b, 1), i32), "cache": make_model(cfg).cache_specs(b, s),
            "pos": ((), i32)}


def input_logical_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical sharding axes parallel to ``input_specs(cfg, shape)``."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", "seq")}
        if cfg.family == "encdec":
            axes["frames"] = ("batch", None, None)
        if cfg.family == "vlm":
            axes["patches"] = ("batch", None, None)
        return axes
    from repro_torch.models.transformer import make_model

    return {"token": ("batch", None), "cache": make_model(cfg).cache_logical_axes(),
            "pos": ()}
