"""GN-LayerNorm (the paper's Algorithm 2, CoRN-LN) in PyTorch.

Counterpart of ``repro/core/gn_layernorm.py``: the 1/sqrt is a Newton
iteration whose initial guess comes from a leading-one detector (the f32
exponent field) refined by a small mantissa LUT, then mul-only steps
``x <- x (1.5 - 0.5 n x^2)``.  These are the plain versions the model runs
on the CPU and that the CUDA kernel in ``kernels/gn_layernorm`` is held
against.  ``gn_layernorm_hwsim`` is the bit-accurate integer datapath of
Fig. 4 (Q8.8 in, wide accumulators, integer LOD and Newton steps).  The
straight-through JVP lives with the kernel wrapper
(``kernels/gn_layernorm/ops.py``).
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import luts
from repro_torch.core.fixedpoint import float_lod, float_mantissa_index
from repro_torch.core.luts import INV_SQRT2, PAPER_RSQRT, RsqrtConfig


@luts.device_tables
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


# --- Bit-accurate integer datapath (Fig. 4) ----------------------------------
@luts.device_tables
def rsqrt_lut_q16_tensor(cfg: RsqrtConfig, device: str) -> torch.Tensor:
    """The mantissa LUT in Q.16, int64, on ``device``."""
    lut = np.round(luts.rsqrt_mantissa_lut(cfg) * (1 << 16)).astype("int64")
    return torch.from_numpy(lut).to(device)


def _int_rsqrt_q16(v: torch.Tensor, cfg: RsqrtConfig) -> torch.Tensor:
    """Integer CoRN rsqrt.  v: int64 variance in Q.16 (> 0).  Returns Q.16.

    LOD (priority encoder) -> mantissa LUT -> ``cfg.iters`` integer NR steps:
        x <- x * (3*2^16 - ((v*x >> 16) * x >> 16)) >> 17
    The LOD reads ``v`` wrapped to int32 with its low bit set, as the
    reference's ``v.astype(int32) | 1``."""
    p = fxp.lod((v & 0xFFFFFFFF) | 1).long()  # leading-one position
    e = p - 16                                # real exponent of n = v / 2^16
    mb = cfg.mantissa_bits
    idx = (v >> (p - mb).clamp_min(0)) & ((1 << mb) - 1)
    x = rsqrt_lut_q16_tensor(cfg, str(v.device))[idx]  # Q.16 of 1/sqrt(mantissa)
    h, o = e >> 1, e & 1
    x = torch.where(o == 1, (x * round(INV_SQRT2 * (1 << 16))) >> 16, x)
    x = torch.where(h >= 0, x >> h.clamp_min(0), x << (-h).clamp_min(0))  # x * 2^-h
    for _ in range(cfg.iters):
        nx = (v * x) >> 16
        nxx = (nx * x) >> 16
        x = (x * ((3 << 16) - nxx)) >> 17
    return x


def gn_layernorm_hwsim(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                       subtract_mean: bool = True):
    """Fig. 4 integer datapath: Q8.8 input, wide (int64) accumulators, the
    integer CoRN rsqrt, a rounding Q8.8 output stage.  The row means are
    floor divisions, as the reference's ``//`` (rows with a negative mean
    round down)."""
    q = fxp.LN_IN_Q
    xi = q.quantize(x.float()).long()  # Q8.8
    c = x.shape[-1]
    ex = torch.div(xi.sum(dim=-1, keepdim=True), c, rounding_mode="floor")  # Q8.8 mean
    ex2 = torch.div((xi * xi).sum(dim=-1, keepdim=True), c, rounding_mode="floor")  # Q.16
    if subtract_mean:
        var = (ex2 - ex * ex).clamp_min(1)
        centered = xi - ex
    else:
        var = ex2.clamp_min(1)
        centered = xi
    rstd = _int_rsqrt_q16(var, cfg)  # Q.16
    y = ((centered * rstd + (1 << 15)) >> 16).float() / q.scale  # Q8.8 out, rounded
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)
