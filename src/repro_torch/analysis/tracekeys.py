"""The engine's (step kind x horizon bucket) trace keys, from configuration
alone.

A copy of ``repro/analysis/tracekeys.py`` (pure Python), so the port
depends on nothing of the JAX package; the tests hold it equal to the
reference's.  In the reference a key is one ``jax.jit`` trace of the tick;
in the port it is one CUDA-graph capture (``serve/graphs.py``).  The tick
specializes only on the step kind (fused or decode) and, for paged pools,
on the horizon bucket: the power-of-two number of block-table columns the
tick reads.
"""
from __future__ import annotations

from typing import Iterable, Optional

STEP_KINDS = ("fused", "decode")


def horizon_bucket_grid(max_seq: int, block_size: int) -> list[int]:
    """Power-of-two horizon buckets for a paged pool: they double from 1 up
    to the per-slot block capacity, which is always the final bucket (so the
    full-horizon read is representable even when capacity is not a power
    of two)."""
    if max_seq <= 0 or block_size <= 0:
        raise ValueError(f"max_seq={max_seq}, block_size={block_size} must be positive")
    max_blocks_per_slot = -(-max_seq // block_size)
    grid: list[int] = []
    b = 1
    while b < max_blocks_per_slot:
        grid.append(b)
        b *= 2
    grid.append(max_blocks_per_slot)
    return grid


def trace_key_space(
    *,
    paged: bool,
    max_seq: Optional[int] = None,
    block_size: Optional[int] = None,
    grid: Optional[Iterable[int]] = None,
) -> set[tuple[str, Optional[int]]]:
    """All (step_kind, bucket) keys a compliant engine may ever trace.

    Slab pools have no horizon dimension: ``{(fused, None), (decode,
    None)}``.  Paged pools cross the step kinds with the bucket grid (pass
    ``grid``, or ``max_seq`` and ``block_size`` to derive it)."""
    if not paged:
        return {(kind, None) for kind in STEP_KINDS}
    if grid is None:
        if max_seq is None or block_size is None:
            raise ValueError("paged trace_key_space needs grid or max_seq+block_size")
        grid = horizon_bucket_grid(max_seq, block_size)
    return {(kind, int(b)) for kind in STEP_KINDS for b in grid}


def compile_bound(
    *,
    paged: bool,
    max_seq: Optional[int] = None,
    block_size: Optional[int] = None,
    grid: Optional[Iterable[int]] = None,
) -> dict[str, int]:
    """Max traces (captures) per step kind implied by the trace-key space."""
    keys = trace_key_space(paged=paged, max_seq=max_seq, block_size=block_size, grid=grid)
    return {kind: sum(1 for k, _ in keys if k == kind) for kind in STEP_KINDS}


def seen_trace_keys(metrics: dict) -> set[tuple[str, Optional[int]]]:
    """Trace keys an engine actually traced, from ``engine.metrics()``."""
    if "horizon_bucket_grid" in metrics:
        return {("fused", int(b)) for b in metrics.get("fused_buckets", [])} | {
            ("decode", int(b)) for b in metrics.get("decode_buckets", [])
        }
    seen: set[tuple[str, Optional[int]]] = set()
    if metrics.get("fused_step_compilations", 0):
        seen.add(("fused", None))
    if metrics.get("decode_compilations", 0):
        seen.add(("decode", None))
    return seen


def format_trace_key_diff(
    expected: set[tuple[str, Optional[int]]],
    seen: set[tuple[str, Optional[int]]],
    counts: Optional[dict[str, int]] = None,
) -> str:
    """Human-readable expected-vs-seen trace-key table for assert messages."""

    def _fmt(keys: set[tuple[str, Optional[int]]]) -> str:
        if not keys:
            return "(none)"
        return ", ".join(
            f"({kind}, bucket={bucket})" if bucket is not None else f"({kind},)"
            for kind, bucket in sorted(keys, key=lambda k: (k[0], -1 if k[1] is None else k[1]))
        )

    lines = [
        "trace-key space (step kind, horizon bucket):",
        f"  allowed : {_fmt(expected)}",
        f"  seen    : {_fmt(seen)}",
    ]
    extra = seen - expected
    if extra:
        lines.append(f"  EXTRA (recompile hazard!): {_fmt(extra)}")
    if counts:
        lines.append(
            "  compilations: "
            + ", ".join(f"{kind}={n}" for kind, n in sorted(counts.items()))
        )
    return "\n".join(lines)
