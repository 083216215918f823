"""Plain PyTorch version of the GN flash-attention kernel.

Mirrors ``repro/kernels/gn_attention/ref.py:gn_attention_ref``: kv heads
repeated over their group of q heads, f32 scores scaled after the dot, the
causal mask ``tril(k=Sk-Sq)`` at -1e30, the one-pass ``core.gn_softmax``,
and the f32 product with v, cast to q's dtype.  The kernel accumulates the
same LUT'd numerators online, so the two agree up to float association and
the Q1.15 rounding of the online corrections.  Its argument order is the
wrapper's, so one can stand in for the other.

``cuda_calls`` counts calls on CUDA tensors, so a run can show that its main
path never fell back to this version there.
"""
from __future__ import annotations

import torch

from repro_torch.core.gn_softmax import gn_softmax
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT

NEG_INF = -1e30

cuda_calls = 0


def gn_attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    causal: bool = False,
    sm_scale: float | None = None,
) -> torch.Tensor:
    global cuda_calls
    if q.is_cuda:
        cuda_calls += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = gn_softmax(s, cfg)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
