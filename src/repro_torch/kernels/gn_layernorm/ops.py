"""GN LayerNorm / RMSNorm wrappers (port of ``repro/kernels/gn_layernorm/ops.py``).

For a CPU tensor the wrapper runs the plain version (``ref``); for a CUDA
tensor it launches the hand-written kernel ``csrc/gn_layernorm.cu`` on the
current stream, or raises.  ``launches`` counts kernel launches and nothing
else.  One device per process: the kernel runs on the current CUDA device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.gn_layernorm import rsqrt_lut_tensor
from repro_torch.core.luts import INV_SQRT2, PAPER_RSQRT, RsqrtConfig
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm import ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _F, _P]

launches = 0


def _entry():
    fn = _build.load("gn_layernorm").gn_layernorm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _launch(x, gamma, beta, cfg: RsqrtConfig, subtract_mean: bool):
    global launches
    cols = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"gn_layernorm kernel takes {list(DTYPE_CODES)}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_layernorm kernel needs a contiguous x")
    if gamma is None:
        gamma = torch.ones(cols, dtype=torch.float32, device=x.device)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is not None and (t.device != x.device or t.dtype != torch.float32
                              or tuple(t.shape) != (cols,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 ({cols},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    lut = rsqrt_lut_tensor(cfg, str(x.device))
    y = torch.empty_like(x)
    rc = _entry()(
        x.data_ptr(), gamma.data_ptr(), None if beta is None else beta.data_ptr(),
        lut.data_ptr(), y.data_ptr(), x.numel() // max(cols, 1), cols,
        float(np.float32(1.0 / cols)), DTYPE_CODES[x.dtype], int(subtract_mean),
        cfg.mantissa_bits, cfg.iters, INV_SQRT2,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "gn_layernorm")
    launches += 1
    return y


def gn_layernorm(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                 subtract_mean: bool = True):
    """GN LayerNorm over the last dim of any shape (RMS with subtract_mean=False)."""
    if x.device.type == "cpu":
        return ref.gn_layernorm_ref(x, gamma, beta, cfg, subtract_mean)
    if x.device.type != "cuda":
        raise ValueError(f"gn_layernorm runs on cpu or cuda tensors, got {x.device}")
    return _launch(x, gamma, beta, cfg, subtract_mean)


def gn_rmsnorm(x, gamma=None, cfg: RsqrtConfig = PAPER_RSQRT):
    """sigma-guaranteed RMSNorm through the same kernel (mean path off)."""
    return gn_layernorm(x, gamma, None, cfg, subtract_mean=False)
