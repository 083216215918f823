"""GN LayerNorm / RMSNorm wrappers (port of ``repro/kernels/gn_layernorm/ops.py``),
and the residual add fused in front of the norm.

For a CPU tensor a wrapper runs the plain version (``ref``); for a CUDA
tensor it launches the hand-written kernel ``csrc/gn_layernorm.cu`` on the
current stream, or raises.  ``launches`` counts kernel launches of both
entries and nothing else; ``launches_fused`` counts the fused entry's apart.
A wrapper does no host sync and allocates only with ``torch.empty``, so a
CUDA graph can capture it.  One device per process: the kernel runs on the
current CUDA device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gn_layernorm import rsqrt_lut_tensor
from repro_torch.core.luts import INV_SQRT2, PAPER_RSQRT, RsqrtConfig
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm import ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C entries' layout codes: a row group's size in threads (a warp, or a
# block of 64 to 256), 0 for the stream layout; ``None`` leaves the pick to
# the C entry
LAYOUTS = {"warp": 32, "block64": 64, "block128": 128, "block256": 256, "stream": 0}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# lut, y, rows, cols, inv_c, dtype, subtract_mean, mantissa_bits, iters,
# inv_sqrt2, layout, stream
_TAIL = [_P, _P, _L, _I, _F, _I, _I, _I, _I, _F, _I, _P]

launches = 0
launches_fused = 0
_luts: dict[tuple, torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library with its entries' signatures set, once a process."""
    lib = _build.load("gn_layernorm")
    for fn, args in ((lib.gn_layernorm_launch, [_P, _P, _P] + _TAIL),
                     (lib.gn_add_layernorm_launch, [_P, _P, _P, _P, _P] + _TAIL),
                     (lib.gn_layernorm_layout, [_L, _I, _I, _I])):
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _lut(cfg: RsqrtConfig, device: torch.device) -> torch.Tensor:
    lut = _luts.get((cfg, device))
    if lut is None:
        lut = _luts[(cfg, device)] = rsqrt_lut_tensor(cfg, str(device))
    return lut


def layout(x: torch.Tensor, r: torch.Tensor | None = None) -> str:
    """The name of the layout the C entry picks for a CUDA x (and r): fresh
    outputs share a 16-byte aligned start, so the inputs must start on one
    too."""
    cols = x.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and (r is None or r.data_ptr() % 16 == 0)
    code = _lib().gn_layernorm_layout(x.numel() // max(cols, 1), cols, DTYPE_CODES[x.dtype],
                                      int(aligned))
    return next(name for name, c in LAYOUTS.items() if c == code)


def _check(x, gamma, beta):
    cols = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"gn_layernorm kernel takes {list(DTYPE_CODES)}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_layernorm kernel needs a contiguous x")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is not None and (t.device != x.device or t.dtype != torch.float32
                              or tuple(t.shape) != (cols,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 ({cols},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(x, r, gamma, beta, cfg: RsqrtConfig, subtract_mean: bool, layout_name):
    """One launch of the norm (r None) or of the fused add + norm."""
    global launches, launches_fused
    _check(x, gamma, beta)
    cols = x.shape[-1]
    if gamma is None:
        gamma = torch.ones(cols, dtype=torch.float32, device=x.device)
    code = -1 if layout_name is None else LAYOUTS[layout_name]
    y = torch.empty_like(x)
    tail = (_lut(cfg, x.device).data_ptr(), y.data_ptr(), x.numel() // max(cols, 1), cols,
            1.0 / cols, DTYPE_CODES[x.dtype], int(subtract_mean), cfg.mantissa_bits, cfg.iters,
            INV_SQRT2, code, torch.cuda.current_stream(x.device).cuda_stream)
    beta_ptr = None if beta is None else beta.data_ptr()
    if r is None:
        rc = _lib().gn_layernorm_launch(x.data_ptr(), gamma.data_ptr(), beta_ptr, *tail)
    else:
        s = torch.empty_like(x)
        rc = _lib().gn_add_layernorm_launch(x.data_ptr(), r.data_ptr(), s.data_ptr(),
                                            gamma.data_ptr(), beta_ptr, *tail)
    _build.check(rc, "gn_layernorm")
    launches += 1
    if r is None:
        return y
    launches_fused += 1
    return s, y


def _device(x, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    return x.device.type


def gn_layernorm(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                 subtract_mean: bool = True, *, layout: str | None = None):
    """GN LayerNorm over the last dim of any shape (RMS with subtract_mean=False).
    ``layout`` forces one of ``LAYOUTS`` on the card (tests, measurements);
    None leaves the pick to the kernel."""
    if _device(x, "gn_layernorm") == "cpu":
        return ref.gn_layernorm_ref(x, gamma, beta, cfg, subtract_mean)
    return _launch(x, None, gamma, beta, cfg, subtract_mean, layout)


def gn_rmsnorm(x, gamma=None, cfg: RsqrtConfig = PAPER_RSQRT, *, layout: str | None = None):
    """sigma-guaranteed RMSNorm through the same kernel (mean path off)."""
    return gn_layernorm(x, gamma, None, cfg, subtract_mean=False, layout=layout)


def gn_add_layernorm(x, r, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                     subtract_mean: bool = True, *, layout: str | None = None):
    """(s, y): s = x + r, rounded to x's dtype as the eager add rounds it,
    and y = the GN norm of s, in one launch on the card.  x and r match in
    shape, dtype (f32 or bf16), device and contiguity."""
    if (x.shape != r.shape or x.dtype != r.dtype or x.device != r.device
            or not (x.is_contiguous() and r.is_contiguous())):
        raise ValueError(f"gn_add_layernorm needs x and r alike and contiguous, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device} and {r.dtype} "
                         f"{tuple(r.shape)} on {r.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"gn_add_layernorm takes {list(DTYPE_CODES)}, got {x.dtype}")
    if _device(x, "gn_add_layernorm") == "cpu":
        return ref.gn_add_layernorm_ref(x, r, gamma, beta, cfg, subtract_mean)
    return _launch(x, r, gamma, beta, cfg, subtract_mean, layout)


def gn_add_rmsnorm(x, r, gamma=None, cfg: RsqrtConfig = PAPER_RSQRT, *,
                   layout: str | None = None):
    """(x + r, RMSNorm of it) through the fused entry."""
    return gn_add_layernorm(x, r, gamma, None, cfg, subtract_mean=False, layout=layout)
