"""Paged GN attention wrappers (port of ``repro/kernels/gn_paged_attention/ops.py``).

``gn_paged_attention_chunk`` is the serving tick's read: a (N, C, H, D)
query chunk per sequence (a decode is C = 1), causal within the chunk, the
prior context read through the block table from the pool's (nb, bs, Hkv, D)
arenas in place.  For CPU tensors the wrapper runs the plain version
(``ref``); for CUDA tensors it launches ``csrc/gn_paged_attention.cu`` on
the current stream, or raises.  ``launches`` counts kernel launches and nothing else.
One device per process: the kernel runs on the current CUDA device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.gn_softmax import exp_lut_tensors
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_paged_attention import ref
from repro_torch.kernels.gn_softmax.ops import exp_lut_args

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 12 + [_I] * 10 + [_F, _F, _F, _I, _I, _I, _I, _I, _F, _P]

launches = 0


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chain_splits(n: int, hkv: int, max_bt: int, device: torch.device) -> tuple[int, int]:
    """(splits, blocks per split): each chain of up to ``max_bt`` blocks is cut
    into contiguous ranges so that the grid has about two blocks per SM."""
    max_bt = max(max_bt, 1)
    want = max(1, -(-2 * _sm_count(device.index) // max(n * hkv, 1)))
    split_blocks = -(-max_bt // min(want, max_bt))
    return -(-max_bt // split_blocks), split_blocks


def _entry():
    fn = _build.load("gn_paged_attention").gn_paged_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k_arena, v_arena, tables, starts, n_valid) -> None:
    dev = q.device
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena), ("tables", tables),
                    ("starts", starts), ("n_valid", n_valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in DTYPE_CODES or k_arena.dtype != q.dtype or v_arena.dtype != q.dtype:
        raise TypeError(f"q and the arenas must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}, {k_arena.dtype}, {v_arena.dtype}")
    for name, t in (("tables", tables), ("starts", starts), ("n_valid", n_valid)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    n, _, h, d = q.shape
    _, _, hkv, dk = k_arena.shape
    if v_arena.shape != k_arena.shape or dk != d or h % hkv or 256 % d:
        raise ValueError(f"bad shapes (head dim must divide 256): q {tuple(q.shape)}, "
                         f"k {tuple(k_arena.shape)}, v {tuple(v_arena.shape)}")
    if tables.dim() != 2 or tables.shape[0] != n or starts.shape != (n,) or n_valid.shape != (n,):
        raise ValueError(f"tables/starts/n_valid must be (N, max_bt)/(N,)/(N,) with N={n}")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("tables", tables), ("starts", starts), ("n_valid", n_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gn_paged_attention_chunk(
    q: torch.Tensor,        # (N, C, H, D) one query chunk per sequence
    k_arena: torch.Tensor,  # (nb, bs, Hkv, D) the pool's arena layout
    v_arena: torch.Tensor,  # (nb, bs, Hkv, D)
    tables: torch.Tensor,   # (N, max_bt) int32
    starts: torch.Tensor,   # (N,) int32 absolute position of query row 0
    n_valid: torch.Tensor,  # (N,) int32 valid lanes (KV read bound)
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Chunked-query paged read.  Row i of sequence n attends the logical
    stream [0, starts[n] + i], bounded by starts + n_valid; rows past
    n_valid are don't-care.  Returns (N, C, H, D) in q's dtype."""
    global launches
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.gn_paged_attention_chunk_ref(q, k_arena, v_arena, tables, starts,
                                                n_valid, cfg, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"gn_paged_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k_arena, v_arena, tables, starts, n_valid)
    n, c, h, d = q.shape
    _, bs, hkv, _ = k_arena.shape
    max_bt = tables.shape[1]
    out = torch.empty_like(q)
    coarse, residual = exp_lut_tensors(cfg, str(q.device))
    splits, split_blocks = chain_splits(n, hkv, max_bt, q.device)
    part = [None, None, None]  # per-range (m, l, acc) for the merge kernel
    if splits > 1:
        rows = (h // hkv) * c
        part = [torch.empty(n, hkv, splits, rows, device=q.device),
                torch.empty(n, hkv, splits, rows, device=q.device),
                torch.empty(n, hkv, splits, rows, d, device=q.device)]
    rc = _entry()(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), tables.data_ptr(),
        starts.data_ptr(), n_valid.data_ptr(), coarse.data_ptr(), residual.data_ptr(),
        out.data_ptr(), *(None if t is None else t.data_ptr() for t in part),
        n, c, h, hkv, d, bs, max_bt, splits, split_blocks, DTYPE_CODES[q.dtype],
        float(sm_scale), *exp_lut_args(cfg), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "gn_paged_attention")
    launches += 1
    return out
