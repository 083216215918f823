"""Plain PyTorch version of the chunked-query GN paged attention kernel.

Mirrors ``repro/kernels/gn_paged_attention/ref.py:gn_paged_attention_chunk_ref``:
gather each sequence's logical KV stream through its block table, repeat
each kv head over its group of q heads, and run the one-pass GN softmax on
f32 scores over the causally visible prefix.  The kernel accumulates the
same LUT'd numerators online, so the two agree up to float association and
LUT-entry rounding of the corrections.  A row that sees no column at all
(an empty sequence) reads nothing and is 0, as in the kernel.

``cuda_calls`` counts calls on CUDA tensors, so a run can show that its main
path never fell back to this version there.
"""
from __future__ import annotations

import torch

from repro_torch.core.gn_softmax import gn_softmax
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT

NEG_INF = -1e30

cuda_calls = 0


def gn_paged_attention_chunk_ref(
    q: torch.Tensor,        # (N, C, H, D) one query chunk per sequence
    k_arena: torch.Tensor,  # (nb, bs, Hkv, D)
    v_arena: torch.Tensor,  # (nb, bs, Hkv, D)
    tables: torch.Tensor,   # (N, max_bt) int32 physical block ids
    starts: torch.Tensor,   # (N,) int32 absolute position of query row 0
    n_valid: torch.Tensor,  # (N,) int32 valid lanes per sequence
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Row i of sequence n attends the gathered stream [0, starts[n] + i],
    bounded by the post-write context starts + n_valid.  Returns (N, C, H, D)."""
    global cuda_calls
    if q.is_cuda:
        cuda_calls += 1
    n, c, h, d = q.shape
    hkv = k_arena.shape[2]
    if sm_scale is None:
        sm_scale = d**-0.5
    idx = tables.long()
    k = k_arena[idx].reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    v = v_arena[idx].reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("nchd,nthd->nhct", q.float(), k.float()) * sm_scale
    col = torch.arange(s.shape[-1], device=q.device)
    rows = starts.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    lengths = (starts + n_valid).long()
    valid = (col[None, None, :] <= rows[:, :, None]) & (col[None, None, :] < lengths[:, None, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    p = gn_softmax(s, cfg)
    out = torch.einsum("nhct,nthd->nchd", p, v.float())
    out = torch.where(valid.any(dim=-1)[:, :, None, None], out, 0.0)
    return out.to(q.dtype)
