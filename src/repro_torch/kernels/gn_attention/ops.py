"""GN flash-attention wrapper (port of ``repro/kernels/gn_attention/ops.py``).

``gn_attention(q, k, v, cfg, causal, sm_scale)`` keeps the reference's
layout: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), q head h reading kv head
h // (H / Hkv); with ``causal`` row i sees the columns up to i + Sk - Sq.
For CPU tensors the wrapper runs the plain version (``ref``); for CUDA
tensors it launches ``csrc/gn_attention.cu`` on the current stream, or
raises.  Unlike the TPU wrapper it pads nothing: the kernel masks the ragged
edges itself.  ``launches`` counts kernel launches and nothing else.  One
device per process: the kernel runs on the current CUDA device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.gn_softmax import exp_lut_tensors
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_attention import ref
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_softmax.ops import exp_lut_args

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_F, _F, _F, _I, _I, _I, _I, _I, _F, _P]
MAX_HEAD_DIM = 256
MAX_GROUP = 64  # q heads per kv head: one block holds 64 rows

launches = 0


def _entry():
    fn = _build.load("gn_attention").gn_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


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


def gn_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """GN attention; returns (B, H, Sq, D) in q's dtype."""
    global launches
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5  # the true head dim, as the reference
    if q.device.type == "cpu":
        return ref.gn_attention_ref(q, k, v, cfg, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"gn_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    coarse, residual = exp_lut_tensors(cfg, str(q.device))
    rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), coarse.data_ptr(),
                  residual.data_ptr(), out.data_ptr(), b, h, hkv, sq, sk, d, int(causal),
                  DTYPE_CODES[q.dtype], float(sm_scale), *exp_lut_args(cfg),
                  torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "gn_attention")
    launches += 1
    return out
