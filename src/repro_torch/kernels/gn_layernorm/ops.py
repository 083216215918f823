"""GN LayerNorm / RMSNorm wrappers (port of ``repro/kernels/gn_layernorm/ops.py``),
and the residual add fused in front of the norm.

For a CPU tensor a wrapper runs the plain version (``ref``); for a CUDA
tensor it launches the hand-written kernel ``csrc/gn_layernorm.cu`` on the
current stream, or raises.  ``launches`` counts kernel launches of both
entries and nothing else; ``launches_fused`` counts the fused entry's apart.
A wrapper does no host sync and allocates only with ``torch.empty``, so a
CUDA graph can capture it.  One device per process: the kernel runs on the
current CUDA device.  ``work`` counts a call's operations and bytes for
the roofline; under the analysis package's op recorder a call is one
opaque record carrying it.

The wrappers are differentiable: when grad is on and an input requires it,
the call runs as a ``torch.autograd.Function`` whose forward is the same
kernel launch (or the plain version on the CPU) and whose backward, in
plain torch, is the transpose of the reference's straight-through JVP
(``repro/core/gn_layernorm.py``): the exact LayerNorm/RMSNorm Jacobian at
the approximated normalizer rstd = newton_rsqrt(var + 1e-8), with the
gradients of gamma and beta summed over the rows.  The fused entries return
(s, y); the gradient that reaches s adds to the one that comes back through
y.  The forward saves only the norm's input s.  The reference has no
Pallas backward.  With grad off, or no input that needs one, nothing is
recorded and the call is the kernel's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.analysis.op_walk import opaque
from repro_torch.core.gn_layernorm import newton_rsqrt, rsqrt_lut_tensor
from repro_torch.core.luts import INV_SQRT2, PAPER_RSQRT, RsqrtConfig
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm import ref
from repro_torch.roofline.analysis import Work

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
    code = _build.launch(x.device, _lib().gn_layernorm_layout, x.numel() // max(cols, 1), cols,
                         DTYPE_CODES[x.dtype], int(aligned))
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
        rc = _build.launch(x.device, _lib().gn_layernorm_launch, x.data_ptr(),
                           gamma.data_ptr(), beta_ptr, *tail)
    else:
        s = torch.empty_like(x)
        rc = _build.launch(x.device, _lib().gn_add_layernorm_launch, x.data_ptr(),
                           r.data_ptr(), s.data_ptr(), gamma.data_ptr(), beta_ptr, *tail)
    _build.check(rc, "gn_layernorm")
    with _build.COUNT_LOCK:
        launches += 1
        launches_fused += r is not None
    return y if r is None else (s, y)


def norm_backward(s, gy, gamma, beta, cfg: RsqrtConfig, subtract_mean: bool):
    """The straight-through vector-Jacobian product of the GN norm of s
    (any shape, rows over the last dim) for the output gradient gy: (ds in
    f32, dgamma, dbeta), the last two f32 row sums or None."""
    s32, gy32 = s.float(), gy.float()
    centered = s32 - s32.mean(dim=-1, keepdim=True) if subtract_mean else s32
    rstd = newton_rsqrt(centered.square().mean(dim=-1, keepdim=True) + 1e-8, cfg)
    xhat = centered * rstd
    cols = s.shape[-1]
    dgamma = (gy32 * xhat).reshape(-1, cols).sum(dim=0) if gamma is not None else None
    dbeta = gy32.reshape(-1, cols).sum(dim=0) if beta is not None else None
    t = gy32 * gamma.float() if gamma is not None else gy32
    dc = rstd * (t - xhat * (xhat * t).mean(dim=-1, keepdim=True))
    if subtract_mean:
        dc = dc - dc.mean(dim=-1, keepdim=True)
    return dc, dgamma, dbeta


class _GNNorm(torch.autograd.Function):
    """The norm (r None) or the fused add + norm, kernel or plain forward."""

    @staticmethod
    def forward(ctx, x, r, gamma, beta, cfg, subtract_mean, layout_name):
        out = _forward(x, r, gamma, beta, cfg, subtract_mean, layout_name)
        s = x if r is None else out[0]
        ctx.save_for_backward(s, gamma, beta)
        ctx.cfg, ctx.subtract_mean, ctx.fused = cfg, subtract_mean, r is not None
        return out

    @staticmethod
    def backward(ctx, *grads):
        s, gamma, beta = ctx.saved_tensors
        gs, gy = grads if ctx.fused else (None, grads[0])
        ds, dgamma, dbeta = norm_backward(s, gy, gamma, beta, ctx.cfg, ctx.subtract_mean)
        ds = ds.to(s.dtype)
        if gs is not None:
            ds = ds + gs
        dr = ds if ctx.fused else None
        return ds, dr, dgamma, dbeta, None, None, None


def _norm(x, r, gamma, beta, cfg, subtract_mean, layout_name):
    """Through ``_GNNorm`` when grad is on and an input needs it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, r, gamma, beta)):
        return _GNNorm.apply(x, r, gamma, beta, cfg, subtract_mean, layout_name)
    return _forward(x, r, gamma, beta, cfg, subtract_mean, layout_name)


# f32 operations an element on the CUDA cores: square, sum, scale, multiply,
# gamma (RMS); the mean and its subtraction, beta and the centered square
# with LayerNorm; one more for the fused residual add
OPS_PER_ELEM = {False: 5, True: 8}


def work(x, r=None, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
         subtract_mean: bool = True, layout_name=None) -> Work:
    """The norm's (or with ``r`` the fused add + norm's) work on these
    inputs, whatever layout runs it: x (and r) read and y (and s) written
    once in x's dtype, gamma and beta read once in f32; f32 operations."""
    fused = r is not None
    cols = x.shape[-1]
    nbytes = (2 + 2 * fused) * x.numel() * x.element_size() + 4 * cols * (
        (gamma is not None) + (beta is not None))
    return Work((OPS_PER_ELEM[subtract_mean] + fused) * x.numel(), nbytes, "f32")


@opaque(lambda x, r, *args: "gn_rmsnorm" if r is None else "gn_rmsnorm_fused", work)
def _forward(x, r, gamma, beta, cfg, subtract_mean, layout_name):
    """The plain version for a CPU tensor, one kernel launch for a CUDA one."""
    if x.device.type == "cpu":
        if r is None:
            return ref.gn_layernorm_ref(x, gamma, beta, cfg, subtract_mean)
        return ref.gn_add_layernorm_ref(x, r, gamma, beta, cfg, subtract_mean)
    return _launch(x, r, gamma, beta, cfg, subtract_mean, layout_name)


def _device(x, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    return x.device.type


def gn_layernorm(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                 subtract_mean: bool = True, *, layout: str | None = None):
    """GN LayerNorm over the last dim of any shape (RMS with subtract_mean=False).
    ``layout`` forces one of ``LAYOUTS`` on the card (tests, measurements);
    None leaves the pick to the kernel."""
    _device(x, "gn_layernorm")
    return _norm(x, None, gamma, beta, cfg, subtract_mean, layout)


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
    _device(x, "gn_add_layernorm")
    return _norm(x, r, gamma, beta, cfg, subtract_mean, layout)


def gn_add_rmsnorm(x, r, gamma=None, cfg: RsqrtConfig = PAPER_RSQRT, *,
                   layout: str | None = None):
    """(x + r, RMSNorm of it) through the fused entry."""
    return gn_add_layernorm(x, r, gamma, None, cfg, subtract_mean=False, layout=layout)
