"""GN-Softmax (the paper's Algorithm 1), float-faithful, in PyTorch.

Counterpart of ``repro/core/gn_softmax.py``: ``exact_softmax`` (the FP32
oracle) and ``gn_softmax`` (two-LUT factorized exponential on a fixed-point
Δ grid, renormalized by the sum of the approximated numerators, so
``Σp = 1`` up to the reciprocal's rounding however coarse the exponential).

The exponential indexes the ROM tables directly (coarse[Δ >> (3+f)] ·
residual[Δ & (R·2^f − 1)], rounded to Q1.15); the reference computes the
same entries arithmetically, and the two agree bitwise on every Δ-grid
point.  The hwsim integer datapath and the straight-through JVP are not
ported yet.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import luts
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT


def exact_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """FP32 reference softmax."""
    x32 = x.float()
    m = x32.amax(dim=dim, keepdim=True)
    e = torch.exp(x32 - m)
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


@functools.lru_cache(maxsize=16)
def exp_lut_tensors(cfg: SoftmaxLUTConfig, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The (coarse, residual) ROM tables as f32 tensors on ``device``."""
    coarse, residual = luts.exp_luts(cfg)
    return (torch.from_numpy(coarse).to(device), torch.from_numpy(residual).to(device))


def delta_index(delta: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """Δ ≥ 0 (f32) -> its saturating integer grid index, round half to even.

    The clamp happens in float, before the cast, so a masked score's huge Δ
    saturates instead of wrapping (an out-of-range float->int cast is
    undefined behaviour on the CPU)."""
    d = torch.round(delta * (1.0 / cfg.step))
    return d.clamp(0, cfg.max_delta_int).to(torch.int32)


def factorized_exp(delta: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """e^{-Δ} on the fixed-point grid via the coarse/residual table pair."""
    coarse, residual = exp_lut_tensors(cfg, str(delta.device))
    d = delta_index(delta, cfg).long()
    frac = d >> (3 + cfg.frac_bits)
    rem = d & (cfg.residual_entries - 1)
    scale = float(1 << cfg.lut_value_bits)
    return torch.round(coarse[frac] * residual[rem] * scale) / scale


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
