"""GN softmax wrapper (port of ``repro/kernels/gn_softmax/ops.py``).

``gn_softmax`` runs row-wise over the last dim of any shape, for f32 or bf16
input, and returns x's dtype.  For a CPU tensor the wrapper runs the plain
version (``ref``); for a CUDA tensor it launches ``csrc/gn_softmax.cu`` on
the current stream, or raises.  Nothing is padded: the kernel masks the
ragged edge itself.  ``launches`` counts kernel launches and nothing else.
One device per process: the kernel runs on the current CUDA device.

The wrapper is differentiable: when grad is on and x requires it, it runs
as a ``torch.autograd.Function`` whose forward is the same kernel (or the
plain version on the CPU) and whose backward, in plain torch, is the
transpose of the reference's straight-through JVP
(``repro/core/gn_softmax.py``): dx = p ⊙ (g − Σ p ⊙ g) at the approximated
p, in f32.  The reference has no Pallas backward.  With grad off, or an
input that needs none, nothing is recorded and the call is the kernel's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.gn_softmax import exp_lut_tensors
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_softmax import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _F, _F, _I, _I, _I, _I, _I, _F, _P]

launches = 0


def _entry():
    fn = _build.load("gn_softmax").gn_softmax_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def exp_lut_args(cfg: SoftmaxLUTConfig) -> tuple:
    """The ``gn::ExpLut`` fields a C entry takes, in its order: step,
    1/step (rounded to f32), saturation index, coarse shift, residual mask,
    the two table sizes and 2^lut_value_bits."""
    return (cfg.step, float(np.float32(1.0 / cfg.step)), cfg.max_delta_int,
            3 + cfg.frac_bits, cfg.residual_entries - 1, cfg.coarse_entries,
            cfg.residual_entries, float(1 << cfg.lut_value_bits))


def softmax_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The straight-through vector-Jacobian product of the GN softmax at
    its output p: p ⊙ (g − Σ p ⊙ g) over the last dim, in f32."""
    p32, g32 = p.float(), g.float()
    return p32 * (g32 - (p32 * g32).sum(dim=-1, keepdim=True))


class _GNSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        p = _forward(x, cfg)
        ctx.save_for_backward(p)
        ctx.x_dtype = x.dtype
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return softmax_backward(p, g).to(ctx.x_dtype), None


def gn_softmax(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """GN softmax over the last dim of an arbitrarily shaped tensor
    (differentiable; see the module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GNSoftmax.apply(x, cfg)
    return _forward(x, cfg)


def _forward(x: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    global launches
    if x.device.type == "cpu":
        return ref.gn_softmax_ref(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"gn_softmax runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"gn_softmax kernel takes {list(DTYPE_CODES)}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_softmax kernel needs a contiguous x")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"gn_softmax needs a non-empty last dim, got {tuple(x.shape)}")
    cols = x.shape[-1]
    rows = x.numel() // cols
    if rows >= 2**31:
        raise ValueError(f"gn_softmax kernel takes fewer than 2^31 rows, got {rows}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    coarse, residual = exp_lut_tensors(cfg, str(x.device))
    rc = _entry()(x.data_ptr(), coarse.data_ptr(), residual.data_ptr(), out.data_ptr(),
                  rows, cols, DTYPE_CODES[x.dtype], *exp_lut_args(cfg),
                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gn_softmax")
    launches += 1
    return out
