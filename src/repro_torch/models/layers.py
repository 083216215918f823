"""Shared building blocks: param init, norm dispatch, MLP, embeddings.

Port of ``repro/models/layers.py``.  Parameters are nested dicts of tensors
with the reference's tree and shapes, so ``convert.py`` can load a JAX
``model.init(...)`` pytree as it is.  The GN norms go through the
``kernels.gn_layernorm`` wrappers: the CUDA kernel for CUDA tensors, the
plain ``core`` function on the CPU; a norm that follows a residual add
takes the wrappers' fused add + norm (``apply_add_norm``), and the SSM
mixers' own gated RMS norms take ``gn_rmsnorm``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import get_norm
from repro_torch.kernels.gn_layernorm import ops as norm_ops

_KERNEL_NORMS = {
    "gn_rms": lambda x, gamma, beta=None: norm_ops.gn_rmsnorm(x, gamma),
    "gn_ln": lambda x, gamma, beta=None: norm_ops.gn_layernorm(x, gamma, beta),
}
_KERNEL_ADD_NORMS = {
    "gn_rms": lambda x, r, gamma, beta=None: norm_ops.gn_add_rmsnorm(x, r, gamma),
    "gn_ln": lambda x, r, gamma, beta=None: norm_ops.gn_add_layernorm(x, r, gamma, beta),
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02


def make_param(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=torch.float32, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=torch.float32, device=device)
    return torch.randn(spec.shape, generator=generator, device=device) * spec.scale


def init_tree(spec_tree, generator: torch.Generator, device):
    """Materialize a nested dict of ParamSpec into f32 tensors, in key order."""
    if isinstance(spec_tree, ParamSpec):
        return make_param(spec_tree, generator, device)
    return {k: init_tree(v, generator, device) for k, v in spec_tree.items()}


def stack_specs(spec_tree, n: int):
    """Prepend the stacked layer dimension to every ParamSpec."""
    if isinstance(spec_tree, ParamSpec):
        return dataclasses.replace(spec_tree, shape=(n, *spec_tree.shape))
    return {k: stack_specs(v, n) for k, v in spec_tree.items()}


# ------------------------------------------------------------------- norms --
def norm_specs(cfg: ModelConfig) -> dict:
    specs = {"gamma": ParamSpec((cfg.d_model,), init="ones")}
    if "ln" in cfg.norm_impl:  # LayerNorm variants carry beta; RMS variants don't
        specs["beta"] = ParamSpec((cfg.d_model,), init="zeros")
    return specs


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    fn = _KERNEL_NORMS.get(cfg.norm_impl) or get_norm(cfg.norm_impl)
    return fn(x, p["gamma"], p.get("beta"))


def apply_add_norm(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, norm(s)) with s = x + r: one fused kernel launch for the GN norms;
    the eager add and ``apply_norm``'s function for the others."""
    fused = _KERNEL_ADD_NORMS.get(cfg.norm_impl)
    if fused is not None:
        return fused(x, r, p["gamma"], p.get("beta"))
    s = x + r
    return s, get_norm(cfg.norm_impl)(s, p["gamma"], p.get("beta"))


def gn_rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's ``core.gn_rmsnorm`` inside a mixer (the mLSTM's
    normalizer without gamma, Mamba2's gated norm with its f32 ``norm``):
    the GN norm kernel on a CUDA tensor, its plain version on the CPU."""
    return norm_ops.gn_rmsnorm(x, gamma)


# -------------------------------------------------------------------- MLP ---
def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wi": ParamSpec((d, f)), "wg": ParamSpec((d, f)), "wo": ParamSpec((f, d))}
    return {"wi": ParamSpec((d, f)), "wo": ParamSpec((f, d))}


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """p holds weights already in x's dtype (``Model.prepare``)."""
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


# -------------------------------------------------------------- embeddings --
def embed_specs(cfg: ModelConfig) -> dict:
    return {"tok": ParamSpec((cfg.vocab, cfg.d_model))}


def lm_head_specs(cfg: ModelConfig) -> dict:
    return {"w": ParamSpec((cfg.d_model, cfg.vocab))}
