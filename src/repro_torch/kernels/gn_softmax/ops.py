"""GN softmax wrappers (port of ``repro/kernels/gn_softmax/ops.py``).

``gn_softmax`` runs row-wise over the last dim of any shape, for f32 or bf16
input, and returns x's dtype.  ``gn_softmax_scores`` takes the raw score
product of an attention layer and does the whole chain the model ran around
the softmax in one pass: times the scale (rounded to the scores' dtype, the
product rounded to it), cast to f32, -1e30 where the mask is False, the GN
softmax, and the probabilities cast to ``out_dtype`` (``ref.scores_chain``).

For a CPU tensor a wrapper runs the plain version (``ref``); for a CUDA
tensor it launches ``csrc/gn_softmax.cuh`` on the current stream, or raises:
from the library built for the input's dtype (``gn_softmax.cu`` for f32,
``gn_softmax_bf16.cu`` for bf16, compiled apart so that they build in
parallel).
Nothing is padded or copied on the way in: the kernel masks the ragged edge
itself and reads the scores and the mask through their strides (a mask is
passed as its broadcast view).  ``launches`` counts kernel launches of both
entries and nothing else.  One device per process: the kernel runs on the
current CUDA device.  ``work`` and ``scores_work`` count a call's
operations and bytes for the roofline; under the analysis package's op
recorder a call is one opaque record carrying them.

The wrappers are differentiable: when grad is on and the input requires
it, the call runs as a ``torch.autograd.Function`` whose forward is the same
kernel (or the plain version on the CPU) and whose backward, in plain torch,
is the transpose of the reference's straight-through JVP
(``repro/core/gn_softmax.py``): dx = p ⊙ (g − Σ p ⊙ g) at the approximated
p, in f32.  ``gn_softmax_scores``' backward is autograd's through the chain,
step by step in the chain's dtypes: that product at the f32 p (which its
forward saves), zeros where masked, the cast to the scores' dtype, times the
scale.  The reference has no Pallas backward.  With grad off, or an input
that needs none, nothing is recorded and the call is the kernel's.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.analysis.op_walk import opaque, tensor_info
from repro_torch.core.gn_softmax import exp_lut_tensors
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_softmax import ref
from repro_torch.roofline.analysis import Work

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LUT = [_F, _F, _I, _I, _I, _I, _I, _F]  # the gn::ExpLut fields (exp_lut_args)
_LONGS = ctypes.POINTER(ctypes.c_longlong)
MAX_DIMS = 5  # the fused entry's scores: up to 4 leading dims and the columns
CHUNK_COLS = 4  # columns a chunk of the kernel's register layouts (csrc K)
# f32 operations an element: max, delta, grid scale, round, LUT product,
# round, sum, scale; the fused entry adds the score scale and the mask
OPS_PER_ELEM, FUSED_OPS = 8, 2

launches = 0


LIBS = {torch.float32: "gn_softmax", torch.bfloat16: "gn_softmax_bf16"}


@functools.cache
def _lib(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The kernel library for inputs of ``dtype``, with its entries'
    signatures set, once a process."""
    lib = _build.load(LIBS[dtype])
    for fn, args in (
            (lib.gn_softmax_launch, [_P, _P, _P, _P, _L, _I, _I] + _LUT + [_P]),
            (lib.gn_softmax_scores_launch,
             [_P, _P, _P, _P, _P, _I, _LONGS, _LONGS, _LONGS, _I, _L, _L, _I, _I, _I, _F]
             + _LUT + [_P]),
            (lib.gn_softmax_layout, [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)])):
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def exp_lut_args(cfg: SoftmaxLUTConfig) -> tuple:
    """The ``gn::ExpLut`` fields a C entry takes, in its order: step,
    1/step (rounded to f32), saturation index, coarse shift, residual mask,
    the two table sizes and 2^lut_value_bits."""
    return (cfg.step, float(np.float32(1.0 / cfg.step)), cfg.max_delta_int,
            3 + cfg.frac_bits, cfg.residual_entries - 1, cfg.coarse_entries,
            cfg.residual_entries, float(1 << cfg.lut_value_bits))


def layout(cols: int) -> tuple[int, int]:
    """The layout the C entries pick for rows of ``cols`` columns (the
    width alone decides): (G, CPT), G threads a row holding CPT chunks of
    ``CHUNK_COLS`` columns a thread, enough for the row and its head shift
    (a row's chunks start on the output's grid of ``CHUNK_COLS`` elements),
    or (0, 0) for the three-pass wide-row kernel (on the card: it asks the
    library)."""
    g, cpt = _I(), _I()
    _build.launch(None, _lib().gn_softmax_layout, cols, ctypes.byref(g), ctypes.byref(cpt))
    return g.value, cpt.value


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


def work(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> Work:
    """The softmax's work on x: every element read and written once in x's
    dtype; f32 operations on the CUDA cores."""
    return Work(OPS_PER_ELEM * x.numel(), 2 * x.numel() * x.element_size(), "f32")


def scores_work(scores: torch.Tensor, scale=None, mask=None, out_dtype=None,
                cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> Work:
    """The fused entry's work: the raw scores read once, the probabilities
    written once in ``out_dtype``, the mask's own elements (not its
    broadcast) read once; f32 operations."""
    out_item = (out_dtype or scores.dtype).itemsize
    mask_bytes = 0 if mask is None else tensor_info(mask).nbytes
    return Work((OPS_PER_ELEM + FUSED_OPS) * scores.numel(),
                scores.numel() * (scores.element_size() + out_item) + mask_bytes, "f32")


@opaque("gn_softmax", work)
def _forward(x: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one; for a
    meta or fake one (``_build.shape_only``) the output's shape alone."""
    global launches
    if _build.shape_only(x):
        return torch.empty_like(x)
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
    rc = _build.launch(
        x.device, _lib(x.dtype).gn_softmax_launch, x.data_ptr(), coarse.data_ptr(),
        residual.data_ptr(), out.data_ptr(), rows, cols, DTYPE_CODES[x.dtype],
        *exp_lut_args(cfg), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gn_softmax")
    with _build.COUNT_LOCK:
        launches += 1
    return out


# ----------------------------------------------------------- fused entry --
class _GNSoftmaxScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, scale, mask, out_dtype, cfg):
        p32 = _scores_forward(scores, scale, mask, torch.float32, cfg)
        ctx.save_for_backward(p32, mask)
        ctx.scale, ctx.s_dtype = scale, scores.dtype
        return p32.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        p32, mask = ctx.saved_tensors
        d = softmax_backward(p32, g.float())
        if mask is not None:
            d = torch.where(mask, d, 0)
        d = d.to(ctx.s_dtype)
        if ctx.scale is not None:
            d = d * torch.tensor(ctx.scale, dtype=d.dtype)
        return d, None, None, None, None


def gn_softmax_scores(scores: torch.Tensor, scale: float | None = None,
                      mask: torch.Tensor | None = None, out_dtype: torch.dtype | None = None,
                      cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """The GN softmax of ``scores * scale`` (in the scores' dtype, the scale
    rounded to it first) as f32 rows, -1e30 where ``mask`` (bool,
    broadcastable to the scores) is False, cast to ``out_dtype`` (default:
    the scores' dtype): ``ref.scores_chain`` in one kernel launch on the
    card.  The scores (f32 or bf16, at most ``MAX_DIMS`` dims, the last of
    unit stride on the card) are read through their strides; the output is
    contiguous.  Differentiable in the scores (see the module docstring)."""
    out_dtype = out_dtype or scores.dtype
    if torch.is_grad_enabled() and scores.requires_grad:
        return _GNSoftmaxScores.apply(scores, scale, mask, out_dtype, cfg)
    return _scores_forward(scores, scale, mask, out_dtype, cfg)


@opaque("gn_softmax_scores", scores_work)
def _scores_forward(scores, scale, mask, out_dtype, cfg) -> torch.Tensor:
    """The plain chain for a CPU tensor, the fused kernel for a CUDA one; for
    a meta or fake one (``_build.shape_only``) the output's shape alone."""
    global launches
    if _build.shape_only(scores):
        return torch.empty(scores.shape, dtype=out_dtype, device=scores.device)
    if scores.device.type == "cpu":
        return ref.gn_softmax_scores_ref(scores, scale, mask, out_dtype, cfg)
    if scores.device.type != "cuda":
        raise ValueError(f"gn_softmax_scores runs on cpu or cuda tensors, got {scores.device}")
    if scores.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"gn_softmax_scores kernel takes {list(DTYPE_CODES)}, got "
                        f"{scores.dtype} -> {out_dtype}")
    if not 1 <= scores.dim() <= MAX_DIMS or scores.shape[-1] == 0:
        raise ValueError(f"gn_softmax_scores takes 1 to {MAX_DIMS} dims and a non-empty last "
                         f"dim, got {tuple(scores.shape)}")
    if scores.stride(-1) != 1:
        raise ValueError("gn_softmax_scores kernel needs scores of unit stride along the last dim")
    cols = scores.shape[-1]
    rows = scores.numel() // cols
    if rows >= 2**31:
        raise ValueError(f"gn_softmax_scores kernel takes fewer than 2^31 rows, got {rows}")
    out = torch.empty(scores.shape, dtype=out_dtype, device=scores.device)
    if rows == 0:
        return out
    lead = list(scores.shape[:-1]) or [1]
    xs = list(scores.stride()[:-1]) or [0]
    ms, mcs, mptr = [0] * len(lead), 0, None
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != scores.device:
            raise TypeError(f"gn_softmax_scores takes a bool mask on {scores.device}, got "
                            f"{mask.dtype} on {mask.device}")
        mview = mask.expand(scores.shape)
        ms, mcs, mptr = list(mview.stride()[:-1]) or [0], mview.stride(-1), mview.data_ptr()
    arr = ctypes.c_longlong * len(lead)
    coarse, residual = exp_lut_tensors(cfg, str(scores.device))
    rscale = 1.0 if scale is None else float(torch.tensor(scale, dtype=scores.dtype))
    rc = _build.launch(
        scores.device, _lib(scores.dtype).gn_softmax_scores_launch, scores.data_ptr(), mptr,
        out.data_ptr(), coarse.data_ptr(), residual.data_ptr(), len(lead), arr(*lead),
        arr(*xs), arr(*ms), cols, 1, mcs, DTYPE_CODES[scores.dtype],
        int(out_dtype == torch.bfloat16), int(scale is not None), rscale, *exp_lut_args(cfg),
        torch.cuda.current_stream(scores.device).cuda_stream)
    _build.check(rc, "gn_softmax_scores")
    with _build.COUNT_LOCK:
        launches += 1
    return out
