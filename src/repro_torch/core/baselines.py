"""Prior-work approximation baselines the paper compares against, in PyTorch.

Counterpart of ``repro/core/baselines.py``.  These are rank-oriented
designs: they keep the ordering but break the normalization (Σp != 1 for
softmax, σ != 1 for LN), which is what Table II and Fig. 5 measure.

* :func:`softermax`          — Softermax [5]: base-2 exponential, low-precision
                               terms and sum.
* :func:`pseudo_softmax`     — pseudo-softmax [6]: 2^(x_i - A) with A the
                               integer exponent of the sum.
* :func:`log_domain_softmax` — Sole [4]-style: log-sum-exp with a LUT'd
                               log2(1+t) correction, unnormalized.
* :func:`integer_layernorm`  — [16]-style integer LN: 1/σ snapped to a power
                               of two.
* :func:`lut_layernorm`      — [15]-style LN: 1/σ from a coarse LUT on var.
* :func:`rmsnorm`            — RMSNorm [7], exact, without mean removal.

All work over the last dim.  ``exp2`` and ``log2`` are evaluated as
``jnp.exp2`` and ``jnp.log2`` lower them, ``exp(ln2 · x)`` and
``log(x) / ln2``, so the port follows the reference's values rather than
the correctly rounded ones (``jnp.exp2(-13.)`` is not 2^-13).  The floor
quantizers and exponent-field tricks make these functions step: one ulp of
an exponential or of a sum in another order moves an output by a
quantization step, or a whole row by 2x.
"""
from __future__ import annotations

import numpy as np
import torch

LOG2E = 1.4426950408889634
_LN2 = float(np.float32(np.log(2.0)))  # the f32 constant of the reference's lowering

# How far two evaluations of a baseline may part when their exponentials,
# logarithms or sums differ by an ulp (another library, another device,
# another summation order): name -> (atol relative to the row's largest
# |output|, the share of rows allowed past it, the largest gap a row may show
# relative to that scale: one floor step of softermax's 8-bit output, a 2x
# exponent move of pseudo, log_domain and integer_ln, a LUT bucket of lut_ln).
PARITY_TOL = {
    "softermax": (0.0, 0.01, 2.0 ** -7),
    "pseudo": (1e-6, 0.01, 1.0),
    "log_domain": (1e-6, 0.01, 1.0),
    "integer_ln": (1e-6, 0.01, 1.0),
    "lut_ln": (1e-6, 0.01, 0.5),
    "rmsnorm": (1e-6, 0.0, 0.0),
}


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x * _LN2)


def _log2(x: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its reciprocal
    return torch.log(x) / torch.full_like(x, _LN2)


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """The unbiased exponent field of f32 ``x`` (and its raw bits)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127, bits


def _quantize_unsigned(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round x in [0, 1] down to ``bits`` fractional bits, as hardware truncates."""
    s = float(1 << bits)
    return torch.floor(x * s) / s


def softermax(x: torch.Tensor, frac_bits: int = 8) -> torch.Tensor:
    """Softermax: p_i = 2^(x_i - m) / Σ 2^(x_j - m), terms, sum and output
    truncated to ``frac_bits`` fixed point: order-preserving, not
    normalized (|1 - Σp| ~ 2^-frac_bits · N)."""
    x32 = x.float()
    m = x32.amax(dim=-1, keepdim=True)
    t = _quantize_unsigned(_exp2(x32 - m), frac_bits)
    z = t.sum(dim=-1, keepdim=True).clamp_min(1.0 / (1 << frac_bits))
    return _quantize_unsigned(t / z, frac_bits).to(x.dtype)


def pseudo_softmax(x: torch.Tensor) -> torch.Tensor:
    """pseudo-softmax [6]: p_i = 2^(x_i·log2e - m) · 2^-E, E the integer
    exponent of the sum (its mantissa dropped): ordering kept, scores off by
    the dropped mantissa in [1, 2)."""
    x32 = x.float() * LOG2E
    t = _exp2(x32 - x32.amax(dim=-1, keepdim=True))
    zexp, _ = _exponent(t.sum(dim=-1, keepdim=True))
    return (t * _exp2(-zexp.float())).to(x.dtype)


def log_domain_softmax(x: torch.Tensor, lut_bits: int = 4) -> torch.Tensor:
    """Sole [4]-style log-domain softmax: lse = m + log2(Σ 2^-d) with d
    truncated to 2 fractional bits, the log2 from the sum's exponent and a
    2^lut_bits-entry LUT of log2(1 + i/2^b) at each bucket's left edge;
    p = 2^(-d - lse), unnormalized."""
    x32 = x.float() * LOG2E
    d = x32.amax(dim=-1, keepdim=True) - x32
    s = _exp2(-_quantize_unsigned(d.clamp_max(31.0), 2)).sum(dim=-1, keepdim=True)
    sexp, sbits = _exponent(s)
    mant_idx = (sbits >> (23 - lut_bits)) & ((1 << lut_bits) - 1)
    lut = _log2(1.0 + torch.arange(1 << lut_bits, dtype=torch.float32, device=x.device)
                / (1 << lut_bits))
    lse = sexp.float() + lut[mant_idx.long()]
    return _exp2(-d - lse).to(x.dtype)


def _centered(x: torch.Tensor):
    """(x - μ, var + 1e-6) over the last dim, in f32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    return x32 - mu, (x32 - mu).square().mean(dim=-1, keepdim=True) + 1e-6


def _affine(y, gamma, beta, dtype):
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(dtype)


def integer_layernorm(x, gamma=None, beta=None) -> torch.Tensor:
    """[16]-style integer LN: 1/σ snapped to a power of two,
    σ̂ = 2^round(log2 σ), so the output's σ is off by up to sqrt(2)."""
    centered, var = _centered(x)
    vexp, vbits = _exponent(var)
    log2var = vexp + ((vbits >> 22) & 1)  # the top mantissa bit rounds to the nearest exponent
    rstd = _exp2(torch.round(-(log2var.float() / 2.0)))
    return _affine(centered * rstd, gamma, beta, x.dtype)


def lut_layernorm(x, gamma=None, beta=None, lut_bits: int = 6) -> torch.Tensor:
    """[15]-style LN: 1/sqrt(var) from a coarse LUT over the var mantissa,
    each entry at its bucket's left edge (a truncating LUT)."""
    centered, var = _centered(x)
    vexp, vbits = _exponent(var)
    idx = (vbits >> (23 - lut_bits)) & ((1 << lut_bits) - 1)
    m_edge = 1.0 + torch.arange(1 << lut_bits, dtype=torch.float32, device=x.device) / (
        1 << lut_bits)
    lut = 1.0 / torch.sqrt(m_edge)
    pow2 = _exp2(-(vexp >> 1).float())
    odd = torch.where((vexp & 1) > 0, 2.0 ** -0.5, 1.0)
    return _affine(centered * (lut[idx.long()] * pow2 * odd), gamma, beta, x.dtype)


def rmsnorm(x, gamma=None, eps: float = 1e-6) -> torch.Tensor:
    """Exact RMSNorm [7]: no mean subtraction."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return _affine(y, gamma, None, x.dtype)
