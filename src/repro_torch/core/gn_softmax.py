"""GN-Softmax (the paper's Algorithm 1), float-faithful, in PyTorch.

Counterpart of ``repro/core/gn_softmax.py``: ``exact_softmax`` (the FP32
oracle), ``gn_softmax`` (two-LUT factorized exponential on a fixed-point
Δ grid, renormalized by the sum of the approximated numerators, so
``Σp = 1`` up to the reciprocal's rounding however coarse the exponential),
``gn_softmax_hwsim`` (the bit-accurate integer datapath of Fig. 3),
``gn_log_softmax``, and ``factorized_exp_ste``, the exponential the
streaming attention (``models/chunked_attention.py``) differentiates.

The exponential indexes the ROM tables directly (coarse[Δ >> (3+f)] ·
residual[Δ & (R·2^f − 1)], rounded to Q1.15); the reference computes the
same entries arithmetically, and the two agree bitwise on every Δ-grid
point.  The straight-through JVP lives with the kernel wrapper
(``kernels/gn_softmax/ops.py``).
"""
from __future__ import annotations


import torch

from repro_torch.core import luts
from repro_torch.core.fixedpoint import RECIP_BITS, shift_subtract_div
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT


def exact_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """FP32 reference softmax."""
    x32 = x.float()
    m = x32.amax(dim=dim, keepdim=True)
    e = torch.exp(x32 - m)
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


@luts.device_tables
def exp_lut_tensors(cfg: SoftmaxLUTConfig, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The (coarse, residual) ROM tables as f32 tensors on ``device``."""
    coarse, residual = luts.exp_luts(cfg)
    return (torch.from_numpy(coarse).to(device), torch.from_numpy(residual).to(device))


def delta_index(delta: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """Δ ≥ 0 (f32) -> its saturating integer grid index, round half to even.

    The reference casts to int32 first and clips the integer after; XLA's
    cast saturates out-of-range values and sends NaN to 0 (a NaN or +Inf
    score makes the row's Δ NaN or +Inf).  An out-of-range float->int cast
    is undefined behaviour in PyTorch, so the same index is formed in float:
    NaN to 0, then the clip, then the cast."""
    return _saturate(torch.round(delta * (1.0 / cfg.step)), cfg)


def _saturate(d: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """A rounded f32 grid index -> int32 in [0, max_delta_int], as XLA's
    saturating cast and the clip after it give it."""
    return d.nan_to_num(0.0).clamp(0, cfg.max_delta_int).to(torch.int32)


@luts.device_tables
def exp_lut_int_tensors(cfg: SoftmaxLUTConfig, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The (coarse, residual) ROM tables as Q1.vb int64 tensors on ``device``."""
    return tuple(torch.from_numpy(t.astype("int64")).to(device) for t in luts.exp_luts_int(cfg))


def factorized_exp(delta: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """e^{-Δ} on the fixed-point grid via the coarse/residual table pair."""
    coarse, residual = exp_lut_tensors(cfg, str(delta.device))
    d = delta_index(delta, cfg).long()
    frac = d >> (3 + cfg.frac_bits)
    rem = d & (cfg.residual_entries - 1)
    scale = float(1 << cfg.lut_value_bits)
    return torch.round(coarse[frac] * residual[rem] * scale) / scale


def factorized_exp_ste(delta: torch.Tensor,
                       cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """``factorized_exp`` with a straight-through backward: the value is the
    fixed-point LUT product, the gradient the exact d/dΔ e^{-Δ} at the
    continuous point (the reference's ``factorized_exp_ste``; inside the
    streaming scan no softmax JVP applies, and the integer quantization
    would otherwise kill the gradient).  The reference forms the value as
    e^{-Δ} + (LUT - e^{-Δ}); here it is the LUT value itself."""
    lut = factorized_exp(delta.detach(), cfg)
    if not delta.requires_grad:
        return lut
    cont = torch.exp(-delta)
    return lut + (cont - cont.detach())


def gn_softmax(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """Algorithm 1, float-faithful, over the last dim."""
    x32 = x.float()
    m = x32.amax(dim=-1, keepdim=True)
    # stabilizer snapped UP onto the Δ grid (see the reference for why)
    m = torch.ceil(m / cfg.step) * cfg.step
    delta = (m - x32).clamp_min(0.0)
    y = factorized_exp(delta, cfg)
    z = y.sum(dim=-1, keepdim=True)
    return (y * (1.0 / z)).to(x.dtype)


def gn_softmax_hwsim(x: torch.Tensor, cfg: SoftmaxLUTConfig = luts.PAPER_SOFTMAX_LUT,
                     recip_bits: int = RECIP_BITS) -> torch.Tensor:
    """Bit-accurate integer datapath of Fig. 3 (max-sub -> LUTs -> FxP_Div).

    The unit quantizes Δ onto its INT grid (in hardware the quantizer lives
    upstream); everything after that is integer: Q1.vb ROM entries, a
    truncating integer product, one restoring shift-subtract division per
    row for the reciprocal scale, and a shift-add rescale rounded to
    nearest.  Bitwise the reference on every input, masked (-1e30), NaN
    and ±Inf scores included: the grid index is formed as ``delta_index``
    forms it (NaN to 0, the clip in float, then the cast)."""
    coarse, residual = exp_lut_int_tensors(cfg, str(x.device))
    vb = cfg.lut_value_bits
    x32 = x.float()
    delta = x32.amax(dim=-1, keepdim=True) - x32
    d = _saturate(torch.round(delta / cfg.step), cfg).long()
    y = (coarse[d >> (3 + cfg.frac_bits)] * residual[d & (cfg.residual_entries - 1)]) >> vb
    z = y.sum(dim=-1, keepdim=True).clamp_min(1)  # the Δ = 0 term keeps z >= ~2^vb
    # FxP_Div: S = floor(2^recip_bits * 2^vb / Z), then every y rescaled
    s = shift_subtract_div(1 << vb, z, recip_bits)
    p_int = (y * s + (1 << (vb - 1))) >> vb
    return (p_int.float() / float(1 << recip_bits)).to(x.dtype)


def gn_log_softmax(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """log(gn_softmax) with a numerically safe floor (for perplexity eval)."""
    return torch.log(gn_softmax(x, cfg).float().clamp_min(1e-30))
