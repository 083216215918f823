"""Config dataclasses, copied field for field from ``repro/configs/base.py``.

The port runs every family the reference runs: dense (with MLA or a top-k
MoE MLP), the SSM (mLSTM) and hybrid (Mamba2 + a shared attention block)
families, the encoder-decoder and the VLM families.
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
