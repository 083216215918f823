"""Paged GN attention wrappers (port of ``repro/kernels/gn_paged_attention/ops.py``).

``gn_paged_attention_chunk`` is the serving tick's read: a (N, C, H, D)
query chunk per sequence (a decode is C = 1), causal within the chunk, the
prior context read through the block table from the pool's (nb, bs, Hkv, D)
arenas in place.  For CPU tensors the wrapper runs the plain version
(``ref``); for CUDA tensors it launches ``csrc/gn_paged_attention.cu`` on
the current stream, or raises.  ``scales`` marks the arenas as int8, with one
f32 dequantization scale per physical block for k and for v (the reference
wrapper's ``scales=``).  ``design`` picks the kernel's design: the
tensor-core design for bf16 q (over bf16 or int8 arenas) when the LUT
numerators split exactly into two bf16, D is a multiple of 16, at most 64
rows share a block and the pointers sit on 16 bytes; the CUDA-core design
otherwise.  With ``nonfinite`` the read also returns, per (N, C, H) row, an
int32 flag: 1 where a live score (visible and inside the length) was NaN or
+-Inf.  The GN exponential turns such a row into a finite distribution, so
the output alone cannot show a poisoned K tile; the GN sentinels read the
flag.  ``launches`` counts the kernel's launches over fp arenas and
``launches_int8`` those over int8 arenas, and nothing else.  One device per
process: the kernel runs on the current CUDA device.  ``work`` counts a
call's operations and bytes for the roofline; under the analysis package's
op recorder a call is one opaque record carrying it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.analysis.op_walk import opaque
from repro_torch.core.gn_softmax import exp_lut_tensors
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT
from repro_torch.kernels import _build
from repro_torch.kernels.gn_attention.ops import CUDA_CORE, MAX_BF16_LUT_BITS, TENSOR_CORE
from repro_torch.kernels.gn_layernorm.ops import DTYPE_CODES
from repro_torch.kernels.gn_paged_attention import ref
from repro_torch.kernels.gn_softmax.ops import exp_lut_args
from repro_torch.roofline.analysis import PRECISION, Work

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 16 + [_I] * 12 + [_F, _F, _F, _I, _I, _I, _I, _I, _F, _P]
INT8_CODE = 2  # the entry's kv dtype code of an int8 arena
MAX_ROWS = 64  # q rows (G * C) one block of the tensor-core design holds
# pages a chain range may hold (two 64-key tiles); None sizes the ranges by
# the card alone.  Measured on an H100 (kernel_ab.py, PERF.md §6), the cap
# was faster at C = 16 and C = 1 in both modes, merge included, and over
# phase 4's ticks.
MAX_RANGE_PAGES: int | None = 8

launches = 0
launches_int8 = 0


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chain_splits(n: int, hkv: int, max_bt: int, device: torch.device) -> tuple[int, int]:
    """(splits, blocks per split): each chain of up to ``max_bt`` blocks is cut
    into contiguous ranges so that the grid has about two blocks per SM, and
    no range holds more than ``MAX_RANGE_PAGES`` blocks where that is set."""
    max_bt = max(max_bt, 1)
    want = max(1, -(-2 * _sm_count(device.index) // max(n * hkv, 1)))
    split_blocks = -(-max_bt // min(want, max_bt))
    if MAX_RANGE_PAGES:
        split_blocks = min(split_blocks, MAX_RANGE_PAGES)
    return -(-max_bt // split_blocks), split_blocks


def design(dtype: torch.dtype, cfg: SoftmaxLUTConfig, d: int, rows: int,
           aligned: bool = True) -> str:
    """The kernel design a CUDA call takes, for q of ``dtype``, head dim ``d``,
    ``rows`` = (H / Hkv) * C q rows a block and pointers on 16 bytes or not."""
    if (dtype == torch.bfloat16 and cfg.lut_value_bits <= MAX_BF16_LUT_BITS and d % 16 == 0
            and d <= 256 and rows <= MAX_ROWS and aligned):
        return TENSOR_CORE
    return CUDA_CORE


def call_design(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> str:
    """``design`` for a call on these tensors."""
    _, c, h, d = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_arena, v_arena))
    return design(q.dtype, cfg, d, (h // k_arena.shape[2]) * c, aligned)


def _entry():
    fn = _build.load("gn_paged_attention").gn_paged_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k_arena, v_arena, tables, starts, n_valid, scales) -> None:
    dev = q.device
    named = [("k_arena", k_arena), ("v_arena", v_arena), ("tables", tables),
             ("starts", starts), ("n_valid", n_valid)]
    if scales is not None:
        named += [("k_scale", scales[0]), ("v_scale", scales[1])]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    kv_dtype = torch.int8 if scales is not None else q.dtype
    if q.dtype not in DTYPE_CODES or k_arena.dtype != kv_dtype or v_arena.dtype != kv_dtype:
        raise TypeError(f"q must be one of {list(DTYPE_CODES)} and the arenas of q's dtype, or "
                        f"int8 with scales; got {q.dtype}, {k_arena.dtype}, {v_arena.dtype}, "
                        f"scales {'given' if scales is not None else 'none'}")
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
    if scales is not None:
        for name, t in (("k_scale", scales[0]), ("v_scale", scales[1])):
            if t.dtype != torch.float32 or t.shape != (k_arena.shape[0],):
                raise ValueError(f"{name} must be f32 of shape ({k_arena.shape[0]},), got "
                                 f"{t.dtype} {tuple(t.shape)}")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def work(q, k_arena, v_arena, tables, starts, n_valid, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
         sm_scale=None, scales=None, nonfinite: bool = False) -> Work:
    """The read's work on these inputs, whatever design runs it: every live
    K and V block once (in int8 mode with its two f32 scales), q read and
    the output written once (with ``nonfinite`` its (N, C, H) int32 flags
    too), the tables and the per-sequence ints; operations: q.k and p.v
    over the visible (row, column) pairs of the valid rows, at q's
    precision.  The live blocks and the visible pairs are what this call's
    lengths (starts + n_valid, read from the device) need; lengths that
    cannot be read (meta or fake tensors, ``_build.shape_only``) count every
    table column of every row, the most the call could need."""
    n, c, h, d = q.shape
    bs, hkv = k_arena.shape[1], k_arena.shape[2]
    blocks = seen = 0
    if _build.shape_only(starts):
        blocks, seen = n * tables.shape[1], n * c * tables.shape[1] * bs
    for s0, nv in ([] if blocks else zip(starts.tolist(), n_valid.tolist())):
        blocks += -(-(s0 + nv) // bs)
        seen += nv * s0 + nv * (nv + 1) // 2  # row i sees s0 + i + 1 columns
    nbytes = (2 * blocks * bs * hkv * d * k_arena.element_size()
              + (2 * 4 * blocks if scales is not None else 0)
              + 2 * q.numel() * q.element_size() + 4 * (tables.numel() + 2 * n)
              + (4 * n * c * h if nonfinite else 0))
    return Work(4 * h * d * seen, nbytes, PRECISION[q.dtype])


def _record_name(q, k_arena, v_arena, tables, starts, n_valid, cfg=None, sm_scale=None,
                 scales=None, nonfinite=False) -> str:
    return "gn_paged_attention" if scales is None else "gn_paged_attention_int8"


@opaque(_record_name, work)
def gn_paged_attention_chunk(
    q: torch.Tensor,        # (N, C, H, D) one query chunk per sequence
    k_arena: torch.Tensor,  # (nb, bs, Hkv, D) the pool's arena layout
    v_arena: torch.Tensor,  # (nb, bs, Hkv, D)
    tables: torch.Tensor,   # (N, max_bt) int32
    starts: torch.Tensor,   # (N,) int32 absolute position of query row 0
    n_valid: torch.Tensor,  # (N,) int32 valid lanes (KV read bound)
    cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT,
    sm_scale: float | None = None,
    scales: tuple[torch.Tensor, torch.Tensor] | None = None,  # ((nb,), (nb,)) f32
    nonfinite: bool = False,
):
    """Chunked-query paged read.  Row i of sequence n attends the logical
    stream [0, starts[n] + i], bounded by starts + n_valid; rows past
    n_valid are don't-care.  ``scales`` = (k_scale, v_scale) marks the arenas
    as int8, dequantized per physical block in f32 after each load.  Returns
    (N, C, H, D) in q's dtype; with ``nonfinite`` also the (N, C, H) int32
    flags of rows that saw a nonfinite live score."""
    global launches, launches_int8
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if _build.shape_only(q):  # meta or fake tensors: the outputs' shapes alone
        out = torch.empty_like(q)
        n, c, h, _ = q.shape
        return (out, torch.empty(n, c, h, dtype=torch.int32, device=q.device)) if nonfinite else out
    if q.device.type == "cpu":
        return ref.gn_paged_attention_chunk_ref(q, k_arena, v_arena, tables, starts,
                                                n_valid, cfg, sm_scale, scales, nonfinite)
    if q.device.type != "cuda":
        raise ValueError(f"gn_paged_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k_arena, v_arena, tables, starts, n_valid, scales)
    n, c, h, d = q.shape
    _, bs, hkv, _ = k_arena.shape
    max_bt = tables.shape[1]
    out = torch.empty_like(q)  # the caching allocator's blocks sit on 512 bytes
    tensor_core = call_design(q, k_arena, v_arena, cfg) == TENSOR_CORE
    coarse, residual = exp_lut_tensors(cfg, str(q.device))
    splits, split_blocks = chain_splits(n, hkv, max_bt, q.device)
    part = [None, None, None, None]  # per-range (m, l, acc, flag) for the merge kernel
    rows = (h // hkv) * c
    if splits > 1:
        part[:3] = [torch.empty(n, hkv, splits, rows, device=q.device),
                    torch.empty(n, hkv, splits, rows, device=q.device),
                    torch.empty(n, hkv, splits, rows, d, device=q.device)]
    flags = None
    if nonfinite:
        flags = torch.empty(n, c, h, dtype=torch.int32, device=q.device)
        if splits > 1:
            part[3] = torch.empty(n, hkv, splits, rows, dtype=torch.int32, device=q.device)
    scale_ptrs = (None, None) if scales is None else (scales[0].data_ptr(), scales[1].data_ptr())
    kv_code = DTYPE_CODES[q.dtype] if scales is None else INT8_CODE
    rc = _build.launch(
        q.device, _entry(), q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), *scale_ptrs,
        tables.data_ptr(), starts.data_ptr(), n_valid.data_ptr(), coarse.data_ptr(),
        residual.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in part[:3]),
        None if flags is None else flags.data_ptr(),
        None if part[3] is None else part[3].data_ptr(),
        n, c, h, hkv, d, bs, max_bt, splits, split_blocks, DTYPE_CODES[q.dtype], kv_code,
        int(tensor_core), float(sm_scale), *exp_lut_args(cfg),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "gn_paged_attention")
    with _build.COUNT_LOCK:
        if scales is None:
            launches += 1
        else:
            launches_int8 += 1
    return (out, flags) if nonfinite else out
