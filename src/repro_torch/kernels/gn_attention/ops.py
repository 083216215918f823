"""GN flash-attention wrapper (port of ``repro/kernels/gn_attention/ops.py``).

``gn_attention(q, k, v, cfg, causal, sm_scale, window)`` keeps the
reference's layout: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), q head h
reading kv head h // (H / Hkv); with ``causal`` row i sees the columns up to
i + Sk - Sq, and a sliding ``window`` > 0 (causal only) keeps the last
``window`` of them, (i + Sk - Sq - window, i + Sk - Sq], the band the
reference's ``windowed_chunked`` attends.  0 is no window.
For CPU tensors the wrapper runs the plain version (``ref``); for CUDA
tensors it launches ``csrc/gn_attention.cu`` on the current stream, or
raises.  ``design`` picks the kernel's design: the tensor-core design for
bf16 with LUT values of at most ``MAX_BF16_LUT_BITS`` bits (it feeds each
LUT numerator to the tensor cores as an exact sum of two bf16, which holds
up to that width), the CUDA-core design for f32 and for finer LUTs.
Unlike the TPU wrapper it pads nothing: the kernel masks the ragged edges
itself.  ``launches`` counts kernel launches and nothing else.  One
device per process: the kernel runs on the current CUDA device.  ``work``
counts a call's operations and bytes for the roofline; under the analysis
package's op recorder a call is one opaque record carrying it.

The wrapper is differentiable: when grad is on and q, k or v requires it,
it runs as a ``torch.autograd.Function``.  Its forward is the same kernel
(the plain version on the CPU) and saves q, k, v and the output o, never
the probabilities.  Its backward, in plain torch, recomputes the f32
scores and their GN softmax (the port's softmax kernel on the card, its
plain version on the CPU), then dS = p ⊙ (dO·Vᵀ − rowsum(dO ⊙ O)): the
transpose of the reference's straight-through softmax JVP through the
one-pass attention, whose gradient the reference's training takes (it has
no Pallas backward).  The kernel's online p and the recomputed one-pass p
may part by a Δ-grid flip on a score; the gradient is straight-through
either way.  The backward holds one layer's (B, H, Sq, Sk) f32 scores at a
time.

Past ``CHUNKED_FROM`` query rows the reference trains through its chunked
attention, differentiating ``factorized_exp_ste`` inside the stream instead
of the softmax JVP.  Every running max there is snapped to the Δ grid and
every rescale is an on-grid LUT value, so its gradient is, up to their
fixed-point rounding, dS_j = e^{-(m - s_j)} / Z · (dP_j − dO·O): m the
row's snapped max, e^{-(m - s_j)} the continuous exponential, Z the sum of
the LUT numerators; dV keeps P.  The backward takes that form there, in
plain torch, over blocks of ``BACKWARD_ROWS`` query rows (one block's
(B, H, rows, Sk) f32 scores at a time).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.op_walk import opaque
from repro_torch.core.gn_softmax import exp_lut_tensors, factorized_exp
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_attention import ref
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_softmax import ops as softmax_ops
from repro_torch.kernels.gn_softmax.ops import exp_lut_args
from repro_torch.roofline.analysis import PRECISION, Work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 10 + [_F, _F, _F, _I, _I, _I, _I, _I, _F, _P]
MAX_HEAD_DIM = 256
MAX_GROUP = 64  # q heads per kv head: one block holds 64 rows
# every multiple of 2^-17 in [0, 1] is exactly bf16(y) + bf16(y - bf16(y))
MAX_BF16_LUT_BITS = 17
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
# past this many query rows the reference streams its GN attention
# (``chunked_attention``) and differentiates the straight-through exponential
CHUNKED_FROM = 2048
BACKWARD_ROWS = 1024  # query rows a block of the straight-through backward

launches = 0


def _entry():
    fn = _build.load("gn_attention").gn_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def design(dtype: torch.dtype, cfg: SoftmaxLUTConfig) -> str:
    """The kernel design a CUDA call takes: the tensor cores for bf16 whose
    LUT numerators split exactly into two bf16, the CUDA cores otherwise."""
    if dtype == torch.bfloat16 and cfg.lut_value_bits <= MAX_BF16_LUT_BITS:
        return TENSOR_CORE
    return CUDA_CORE


def _check(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, H, Sq, D), k = v (B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    bk, hkv, _, dk = k.shape
    if bk != b or dk != d or hkv < 1 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, D or the "
                         "head grouping")
    if not 1 <= d <= MAX_HEAD_DIM or h // hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes head dims 1..{MAX_HEAD_DIM} and up to {MAX_GROUP} "
                         f"q heads per kv head, got D={d}, group {h // hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def attention_backward(q, k, v, o, do, cfg: SoftmaxLUTConfig, causal: bool,
                       sm_scale: float, window: int = 0):
    """(dq, dk, dv) in f32 for the output gradient do: the scores and
    their GN softmax recomputed (see the module docstring), kv heads
    summed over their group of q heads."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    if sq > CHUNKED_FROM:
        return _ste_backward(q, k, v, o, do, cfg, causal, sm_scale, window)
    q32, do32, o32 = q.float(), do.float(), o.float()
    k32 = k.float().repeat_interleave(group, dim=1)
    v32 = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * sm_scale
    if causal:
        s = torch.where(ref.band_mask(sq, sk, window, q.device), s, ref.NEG_INF)
    p = softmax_ops.gn_softmax(s, cfg)
    del s
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do32, v32)
              - (do32 * o32).sum(dim=-1, keepdim=True))
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * sm_scale
    return (dq, dk.reshape(b, hkv, group, sk, d).sum(dim=2),
            dv.reshape(b, hkv, group, sk, d).sum(dim=2))


def _ste_backward(q, k, v, o, do, cfg: SoftmaxLUTConfig, causal: bool, sm_scale: float,
                  window: int):
    """The straight-through gradient past ``CHUNKED_FROM`` (module
    docstring), a block of query rows at a time."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    k32 = k.float().repeat_interleave(group, dim=1)
    v32 = v.float().repeat_interleave(group, dim=1)
    dq = torch.empty(b, h, sq, d, dtype=torch.float32, device=q.device)
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    mask = ref.band_mask(sq, sk, window, q.device) if causal else None
    for r0 in range(0, sq, BACKWARD_ROWS):
        r1 = min(r0 + BACKWARD_ROWS, sq)
        q32, do32 = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        s = torch.matmul(q32, k32.transpose(-1, -2)) * sm_scale
        live = None if mask is None else mask[r0:r1]
        if live is not None:
            s = torch.where(live, s, ref.NEG_INF)
        m = torch.ceil(s.amax(dim=-1, keepdim=True) / cfg.step) * cfg.step
        delta = (m - s).clamp_min(0.0)
        del s
        y = factorized_exp(delta, cfg)
        e = torch.exp(-delta)
        del delta
        if live is not None:
            y, e = torch.where(live, y, 0.0), torch.where(live, e, 0.0)
        inv_z = 1.0 / y.sum(dim=-1, keepdim=True)
        dv += torch.matmul((y * inv_z).transpose(-1, -2), do32)
        del y
        g = torch.matmul(do32, v32.transpose(-1, -2)) - (
            do32 * o[:, :, r0:r1].float()).sum(dim=-1, keepdim=True)
        ds = e * inv_z * g
        del e, g
        dq[:, :, r0:r1] = torch.matmul(ds, k32) * sm_scale
        dk += torch.matmul(ds.transpose(-1, -2), q32) * sm_scale
    return (dq, dk.reshape(b, hkv, group, sk, d).sum(dim=2),
            dv.reshape(b, hkv, group, sk, d).sum(dim=2))


class _GNAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg, causal, sm_scale, window):
        o = _forward(q, k, v, cfg, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.cfg, ctx.causal, ctx.sm_scale, ctx.window = cfg, causal, sm_scale, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, do, ctx.cfg, ctx.causal, ctx.sm_scale,
                                        ctx.window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def gn_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """GN attention; returns (B, H, Sq, D) in q's dtype (differentiable;
    see the module docstring)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5  # the true head dim, as the reference
    window = int(window or 0)
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: a sliding window is >= 0 and bounds a causal call")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _GNAttention.apply(q, k, v, cfg, causal, sm_scale, window)
    return _forward(q, k, v, cfg, causal, sm_scale, window)


def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """(row, column) pairs a call attends: all of them, or with ``causal``
    row i sees the columns (i + Sk - Sq - window, i + Sk - Sq] within
    [0, Sk) (no lower edge without a window)."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = min(i + sk - sq, sk - 1)
        lo = max(i + sk - sq - window + 1, 0) if window else 0
        total += max(0, hi - lo + 1)
    return total


def work(q, k, v, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT, causal: bool = False,
         sm_scale=None, window: int = 0) -> Work:
    """The attention's work on these inputs, whatever design runs it: q, k
    and v read and the output (q's shape) written once; operations: q.k
    and p.v over the visible (row, column) pairs, at q's precision."""
    b, h, sq, d = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return Work(4 * b * h * d * visible_pairs(sq, k.shape[2], causal, int(window or 0)),
                nbytes, PRECISION[q.dtype])


@opaque("gn_attention", work)
def _forward(q, k, v, cfg: SoftmaxLUTConfig, causal: bool, sm_scale: float,
             window: int = 0) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA ones."""
    global launches
    if q.device.type == "cpu":
        return ref.gn_attention_ref(q, k, v, cfg, causal, sm_scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"gn_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    coarse, residual = exp_lut_tensors(cfg, str(q.device))
    rc = _build.launch(q.device, _entry(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       coarse.data_ptr(), residual.data_ptr(), out.data_ptr(), b, h, hkv, sq,
                       sk, d, int(causal), window, DTYPE_CODES[q.dtype],
                       int(design(q.dtype, cfg) == TENSOR_CORE), float(sm_scale),
                       *exp_lut_args(cfg), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "gn_attention")
    with _build.COUNT_LOCK:
        launches += 1
    return out
