"""Plain PyTorch version of the chunked-query GN paged attention kernel.

Mirrors ``repro/kernels/gn_paged_attention/ref.py:gn_paged_attention_chunk_ref``:
gather each sequence's logical KV stream through its block table, repeat
each kv head over its group of q heads, and run the one-pass GN softmax on
f32 scores over the causally visible prefix.  The kernel accumulates the
same LUT'd numerators online, so the two agree up to float association and
LUT-entry rounding of the corrections.  With ``scales`` the arenas are int8:
blocks are gathered as int8, then dequantized in f32 by their block's scale,
as the Pallas kernel dequantizes each tile after its load
(``kernel.py:97-104``); the reference's streamed jnp read multiplies in the
activation dtype instead (``models/attention.py:430``).  A row that sees no
column at all (an empty sequence) reads nothing and is 0, as in the kernel.
Blocks past a sequence's context are not read either, as the kernels read
none (a stale table entry may name any block): their V is taken as 0, so a
nonfinite tile there cannot reach the output through a zero weight (0 · NaN
= NaN), which leaves every finite result unchanged.

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
    scales: tuple[torch.Tensor, torch.Tensor] | None = None,  # ((nb,), (nb,)) f32
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
    k, v = k_arena[idx].float(), v_arena[idx].float()  # (N, max_bt, bs, Hkv, D)
    if scales is not None:
        k = k * scales[0][idx][..., None, None, None]
        v = v * scales[1][idx][..., None, None, None]
    k = k.reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    v = v.reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("nchd,nthd->nhct", q.float(), k) * sm_scale
    col = torch.arange(s.shape[-1], device=q.device)
    rows = starts.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    lengths = (starts + n_valid).long()
    valid = (col[None, None, :] <= rows[:, :, None]) & (col[None, None, :] < lengths[:, None, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    read = col[None, :] < (-(-lengths // k_arena.shape[1]) * k_arena.shape[1])[:, None]
    v = torch.where(read[:, :, None, None], v, 0.0)
    p = gn_softmax(s, cfg)
    out = torch.einsum("nhct,nthd->nchd", p, v)
    out = torch.where(valid.any(dim=-1)[:, :, None, None], out, 0.0)
    return out.to(q.dtype)
