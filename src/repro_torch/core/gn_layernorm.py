"""GN-LayerNorm (the paper's Algorithm 2, CoRN-LN) in PyTorch.

Counterpart of ``repro/core/gn_layernorm.py``: the 1/sqrt is a Newton
iteration whose initial guess comes from a leading-one detector (the f32
exponent field) refined by a small mantissa LUT, then mul-only steps
``x <- x (1.5 - 0.5 n x^2)``.  These are the plain versions the model runs
on the CPU and that the CUDA kernel in ``kernels/gn_layernorm`` is held
against.  The hwsim integer datapath and the straight-through JVP are not
ported yet.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import luts
from repro_torch.core.luts import INV_SQRT2, PAPER_RSQRT, RsqrtConfig


def float_lod(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive f32 via exponent-field extraction."""
    bits = x.float().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def float_mantissa_index(x: torch.Tensor, lut_bits: int) -> torch.Tensor:
    """Top ``lut_bits`` of the f32 mantissa (index into a refinement LUT)."""
    bits = x.float().view(torch.int32)
    return (bits >> (23 - lut_bits)) & ((1 << lut_bits) - 1)


@functools.lru_cache(maxsize=16)
def rsqrt_lut_tensor(cfg: RsqrtConfig, device: str) -> torch.Tensor:
    return torch.from_numpy(luts.rsqrt_mantissa_lut(cfg)).to(device)


def exact_layernorm(x, gamma=None, beta=None, eps: float = 1e-6):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def exact_rmsnorm(x, gamma=None, eps: float = 1e-6):
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps)
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype)


def newton_rsqrt(n: torch.Tensor, cfg: RsqrtConfig = PAPER_RSQRT) -> torch.Tensor:
    """CoRN reciprocal square root: LOD + mantissa LUT + mul-only NR steps."""
    n32 = n.float()
    e = float_lod(n32)
    idx = float_mantissa_index(n32, cfg.mantissa_bits)
    m_r = rsqrt_lut_tensor(cfg, str(n32.device))[idx.long()]
    e_half = e >> 1                                # arithmetic shift == floor
    # 2^{-e_half} built by exponent-field assembly (no transcendental)
    pow2 = ((127 - e_half) << 23).to(torch.int32).view(torch.float32)
    odd = torch.where((e & 1) > 0, INV_SQRT2, 1.0)
    x = m_r * pow2 * odd
    for _ in range(cfg.iters):
        x = x * (1.5 - 0.5 * n32 * x * x)
    return x


def _gn_normalize(x, gamma, beta, cfg: RsqrtConfig, subtract_mean: bool):
    x32 = x.float()
    if subtract_mean:
        # centred (cancellation-free) variance, as the reference
        centered = x32 - x32.mean(dim=-1, keepdim=True)
    else:
        centered = x32
    var = centered.square().mean(dim=-1, keepdim=True)
    y = centered * newton_rsqrt(var + 1e-8, cfg)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def gn_layernorm(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT):
    """Algorithm 2: sigma-guaranteed LayerNorm (mean subtraction on)."""
    return _gn_normalize(x, gamma, beta, cfg, True)


def gn_rmsnorm(x, gamma=None, cfg: RsqrtConfig = PAPER_RSQRT):
    """sigma-guaranteed RMSNorm (mean path off, Newton unit unchanged)."""
    return _gn_normalize(x, gamma, None, cfg, False)
