"""LUT construction for the GN-Softmax / GN-LayerNorm approximation units.

A copy of the reference tables (``repro/core/luts.py``), numpy only, so the
port depends on nothing of the JAX package.  The tests hold every array and
constant here bitwise equal to the reference's.

  * coarse LUT, 7 entries:  CLUT[k] = e^{-R * k * s},  k = 0..6
  * residual LUT          :  RLUT[j] = e^{-j * s},      j = 0..R*2^f - 1
  * CoRN rsqrt mantissa LUT: 1/sqrt(m) at the bucket midpoints, Q.16-rounded
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

RADIX = 8  # paper's R


@dataclasses.dataclass(frozen=True)
class SoftmaxLUTConfig:
    """Configuration of the two-LUT exponential unit."""

    frac_bits: int = 0        # f: fractional bits of the Δ grid (paper: 0)
    coarse_entries: int = 7   # paper: 7 (e^{-8*6} already ~0 in Q1.15)
    lut_value_bits: int = 15  # Q1.15 LUT entries
    delta_scale: float = 1.0  # s0: logit units per integer step

    @property
    def residual_entries(self) -> int:
        return RADIX * (1 << self.frac_bits)

    @property
    def step(self) -> float:
        """Δ units represented by one integer step."""
        return self.delta_scale / (1 << self.frac_bits)

    @property
    def max_delta_int(self) -> int:
        """Largest representable Δ index (saturation point)."""
        return self.coarse_entries * self.residual_entries - 1


PAPER_SOFTMAX_LUT = SoftmaxLUTConfig(frac_bits=0)
TPU_SOFTMAX_LUT = SoftmaxLUTConfig(frac_bits=3)


@functools.lru_cache(maxsize=32)
def exp_luts(cfg: SoftmaxLUTConfig) -> tuple[np.ndarray, np.ndarray]:
    """(coarse, residual) LUTs as float32, already fixed-point-rounded."""
    scale = float(1 << cfg.lut_value_bits)
    k = np.arange(cfg.coarse_entries, dtype=np.float64)
    coarse = np.exp(-float(RADIX) * cfg.delta_scale * k)
    j = np.arange(cfg.residual_entries, dtype=np.float64)
    residual = np.exp(-j * cfg.step)
    coarse_q = np.round(coarse * scale) / scale
    residual_q = np.round(residual * scale) / scale
    return coarse_q.astype(np.float32), residual_q.astype(np.float32)


def exp_luts_int(cfg: SoftmaxLUTConfig) -> tuple[np.ndarray, np.ndarray]:
    """Integer (Q1.f) LUT entries for the bit-accurate hwsim datapath."""
    coarse, residual = exp_luts(cfg)
    scale = float(1 << cfg.lut_value_bits)
    return (
        np.round(coarse * scale).astype(np.int32),
        np.round(residual * scale).astype(np.int32),
    )


@dataclasses.dataclass(frozen=True)
class RsqrtConfig:
    """LOD + mantissa-LUT initial guess, then ``iters`` NR-rsqrt steps."""

    mantissa_bits: int = 5   # 32-entry compressed LUT
    iters: int = 2           # paper: 2-cycle Newton
    lut_value_bits: int = 16


PAPER_RSQRT = RsqrtConfig(mantissa_bits=5, iters=2)


@functools.lru_cache(maxsize=32)
def rsqrt_mantissa_lut(cfg: RsqrtConfig) -> np.ndarray:
    """LUT[i] ~= 1/sqrt(m) for mantissa bucket m in [1 + i/2^b, 1 + (i+1)/2^b)."""
    n = 1 << cfg.mantissa_bits
    i = np.arange(n, dtype=np.float64)
    mid = 1.0 + (i + 0.5) / n
    vals = 1.0 / np.sqrt(mid)
    scale = float(1 << cfg.lut_value_bits)
    return (np.round(vals * scale) / scale).astype(np.float32)


# sqrt(1/2) constant for odd-exponent correction, fixed-point rounded.
INV_SQRT2 = float(np.round((2.0 ** -0.5) * (1 << 16)) / (1 << 16))
