"""Core: the paper's contribution, GN-Softmax and GN-LayerNorm (CoRN-LN)."""
from repro_torch.core.api import get_norm, get_softmax
from repro_torch.core.gn_layernorm import (
    exact_layernorm,
    exact_rmsnorm,
    gn_layernorm,
    gn_layernorm_hwsim,
    gn_rmsnorm,
    newton_rsqrt,
)
from repro_torch.core.gn_softmax import (
    exact_softmax,
    gn_log_softmax,
    gn_softmax,
    gn_softmax_hwsim,
)
from repro_torch.core.luts import (
    PAPER_RSQRT,
    PAPER_SOFTMAX_LUT,
    TPU_SOFTMAX_LUT,
    RsqrtConfig,
    SoftmaxLUTConfig,
)
from repro_torch.core.metrics import (
    error_histogram,
    layernorm_norm_error,
    softmax_norm_error,
)

__all__ = [
    "get_norm",
    "get_softmax",
    "exact_layernorm",
    "exact_rmsnorm",
    "gn_layernorm",
    "gn_layernorm_hwsim",
    "gn_rmsnorm",
    "newton_rsqrt",
    "exact_softmax",
    "gn_log_softmax",
    "gn_softmax",
    "gn_softmax_hwsim",
    "PAPER_RSQRT",
    "PAPER_SOFTMAX_LUT",
    "TPU_SOFTMAX_LUT",
    "RsqrtConfig",
    "SoftmaxLUTConfig",
    "error_histogram",
    "layernorm_norm_error",
    "softmax_norm_error",
]
