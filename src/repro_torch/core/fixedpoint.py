"""Fixed-point (Q-format) arithmetic of the hardware units, in PyTorch.

Counterpart of ``repro/core/fixedpoint.py``: the paper's datapath is
INT8-in / fixed-point-internal, simulated bit-accurately on integer tensors
so the accuracy experiments measure the hardware's numbers.  The reference
runs it on int32 and, inside ``enable_x64``, int64 arrays; here the wide
values are int64 tensors throughout.

A Q(f) value stores ``round(x * 2**f)`` as an integer; ``f`` is the number
of fractional bits.

Float -> int casts: XLA's cast saturates out-of-range values and sends NaN
to 0; PyTorch's is undefined there (x86 gives INT_MIN).  Every cast below
forms its integer in float first (NaN to 0, the clip, then the cast), which
gives the reference's integer for every input.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Fixed-point format: ``total_bits`` wide, ``frac_bits`` fractional."""

    total_bits: int
    frac_bits: int
    signed: bool = False

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_int(self) -> int:
        if self.signed:
            return 2 ** (self.total_bits - 1) - 1
        return 2 ** self.total_bits - 1

    @property
    def min_int(self) -> int:
        if self.signed:
            return -(2 ** (self.total_bits - 1))
        return 0

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Float -> saturating Q(f) int32 (round half to even; NaN -> 0)."""
        q = torch.round(x * self.scale).nan_to_num(0.0)
        return q.clamp(self.min_int, self.max_int).to(torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return q.float() / self.scale


# Formats of the paper-faithful datapath: softmax Δ, LUT entries, products;
# the LayerNorm's input and standard deviation.
DELTA_Q = QFormat(total_bits=8, frac_bits=0)          # INT8 Δ (paper Table III)
LUT_Q = QFormat(total_bits=16, frac_bits=15)          # LUT entries in Q1.15
PROD_Q = QFormat(total_bits=16, frac_bits=15)         # y = a*b, renormalized
RECIP_BITS = 24  # D_max = 2**24 in FxP_Div (24-bit probabilities)
LN_IN_Q = QFormat(total_bits=16, frac_bits=8, signed=True)
LN_STD_Q = QFormat(total_bits=24, frac_bits=16)

_U32 = 0xFFFFFFFF


def shift_subtract_div(numer, denom, out_bits: int) -> torch.Tensor:
    """Restoring (shift-subtract) integer division: floor(numer << out_bits / denom).

    The paper's FxP_Div: one sequential divider per row, 46 + ``out_bits``
    MSB-first steps over the virtual numerator ``numer << out_bits``,
    shifting the partial remainder (never the divisor), as the RTL's shift
    register does.  numer/denom: integer tensors or ints (denom > 0,
    numer <= 46 bits; the partial remainder and quotient stay below 2**63).
    Returns the int64 quotient, broadcast over both, on the device of the
    tensor given (numer's if both are)."""
    dev = next((t.device for t in (numer, denom) if isinstance(t, torch.Tensor)), None)
    numer = torch.as_tensor(numer, dtype=torch.int64, device=dev)
    denom = torch.as_tensor(denom, dtype=torch.int64, device=dev)
    numer, denom = torch.broadcast_tensors(numer, denom)
    total_bits = 46 + out_bits
    rem = torch.zeros_like(numer)
    quot = torch.zeros_like(numer)
    for i in range(total_bits):
        src = total_bits - 1 - i - out_bits
        rem = rem << 1
        if src >= 0:
            rem = rem | ((numer >> src) & 1)
        take = rem >= denom
        rem = torch.where(take, rem - denom, rem)
        quot = (quot << 1) | take.to(torch.int64)
    return quot


def lod(x: torch.Tensor) -> torch.Tensor:
    """Leading-one detector: position of the highest set bit of x read as
    uint32 (lod(0) == lod(1) == 0, lod(2) == lod(3) == 1, ...): the
    reference's 32-step priority-encoder loop.  PyTorch's uint32 has no
    shifts, so the loop runs on int64 masked to 32 bits, which keeps the
    reference's wrap of negative int32 inputs.  Returns int32."""
    xs = x.to(torch.int64) & _U32
    pos = torch.zeros_like(xs, dtype=torch.int32)
    for _ in range(32):
        has = xs > 1
        pos = pos + has.to(torch.int32)
        xs = torch.where(has, xs >> 1, xs)
    return pos


def float_lod(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive f32 via exponent-field extraction (the
    analogue of a hardware leading-one detector: bit-cast and mask)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def float_mantissa_index(x: torch.Tensor, lut_bits: int) -> torch.Tensor:
    """Top ``lut_bits`` of the f32 mantissa (index into a refinement LUT)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits >> (23 - lut_bits)) & ((1 << lut_bits) - 1)
