"""Config dataclasses, copied field for field from ``repro/configs/base.py``.

The port runs every family the reference runs: dense (with MLA or a top-k
MoE MLP), the SSM (mLSTM) and hybrid (Mamba2 + a shared attention block)
families, the encoder-decoder and the VLM families.  The parameter counts
(``ModelConfig.param_count``, ``active_param_count``) and the production
shapes of the multi-pod dry run (``ShapeConfig``, ``shapes_for_arch``) are
the reference's formulas and tables, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 2048


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"  # 'mamba2' | 'mlstm'
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    # the chunked forms' block length (training and static prefills whose
    # length it divides); 0: the per-token recurrence everywhere
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads

    softmax_impl: str = "gn"
    norm_impl: str = "gn_rms"
    moe_dispatch: str = "einsum"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: int = 0
    attn_every: int = 0
    cross_attn_every: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 1500
    num_patches: int = 1601
    mlp_act: str = "swiglu"        # swiglu | gelu

    rope_theta: float = 10000.0
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"

    scan_layers: bool = True
    remat: str = "full"
    use_pallas: bool = False
    opt_state_dtype: str = "float32"
    microbatches: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_features(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_features(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameters N (for 6·N·D model-flops accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        if self.family in ("ssm", "hybrid"):
            return _ssm_param_count(self)
        attn = d * self.q_features + 2 * d * self.kv_features + self.q_features * d
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        if self.moe is not None:
            mlp = self.moe.num_experts * 3 * d * f + d * self.moe.num_experts
        elif self.mlp_act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = attn + mlp + 2 * d
        total = self.n_layers * per_layer + v * d + d * v + d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.n_layers * (attn + d)  # decoder cross-attn
        if self.family == "vlm" and self.cross_attn_every:
            total += (self.n_layers // self.cross_attn_every) * (attn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.moe.num_experts * 3 * d * f
        return dense + self.n_layers * self.moe.top_k * 3 * d * f


def _ssm_param_count(cfg: ModelConfig) -> int:
    d = cfg.d_model
    s = cfg.ssm
    d_in = s.expand * d
    if s.kind == "mlstm":
        dh = d_in // cfg.n_heads
        per_layer = d * 2 * d_in + 3 * cfg.n_heads * dh * dh + 3 * d_in + d_in * d + 2 * d
    else:  # mamba2
        nheads = d_in // s.head_dim
        per_layer = (
            d * (2 * d_in + 2 * s.state_dim + nheads)
            + s.conv_dim * (d_in + 2 * s.state_dim)
            + d_in * d
            + 2 * d
            + 2 * nheads
        )
    total = cfg.n_layers * per_layer + 2 * cfg.vocab * d + d
    if cfg.family == "hybrid" and cfg.attn_every:
        attn = d * cfg.q_features + 2 * d * cfg.kv_features + cfg.q_features * d
        total += attn + d  # one shared attention block (zamba2 trick)
    return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# long_500k needs sub-quadratic attention: run only where the arch provides it
# (SSM state, hybrid, or sliding-window)
LONG_CONTEXT_ARCHS = ("xlstm-350m", "zamba2-7b", "mixtral-8x22b")


def shapes_for_arch(arch_name: str):
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_name in LONG_CONTEXT_ARCHS:
        out.append(LONG_500K)
    return tuple(out)
