"""repro_torch.analysis: the invariant auditor and the CUDA-graph-hazard
lint (the port's counterpart of ``repro.analysis``).

Every guarantee the serving tick advertises (no host transfer inside a
tick, captures bounded by the (step kind, horizon bucket) grid, no fp64,
caches written in place, no full-width upcast of int8 arenas, gather-free
paged reads, connected GN probes) is held at run time by launch counters
and bitwise eager-against-graphed checks.  This package checks the same
invariants from the program itself:

* **Pass A** (``audit``) records one eager call of every serving entry
  point (each tick kind at its captured bucket, the sentinel step, the
  pool's in-place copies) for each registry arch with a
  ``TorchDispatchMode`` (``op_walk``; each hand-written kernel one opaque
  record) and asserts the structural invariants on the op trace.
* **Pass B** (``lint``) is an AST lint for CUDA-graph hazards inside tick
  bodies (the functions ``StepGraphs.run`` captures): Python branches,
  casts or numpy on a tensor's value, a cache leaf rebound instead of
  written in place; and over every file unhashable graph keys, mutable
  defaults and unused imports.

CLI: ``python -m repro_torch.analysis --all [--device cpu]``.  Each rule
carries a known-bad fixture it must flag and a known-good twin it must
pass (``--self-check``); ``--break-invariant RULE`` feeds the bad fixture
through the real pipeline and must exit non-zero with that rule id.
"""
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.rules import ALL_RULES, AUDIT_RULES, LINT_RULES
from repro_torch.analysis.tracekeys import (
    compile_bound,
    format_trace_key_diff,
    horizon_bucket_grid,
    trace_key_space,
)

__all__ = [
    "Finding",
    "Report",
    "ALL_RULES",
    "AUDIT_RULES",
    "LINT_RULES",
    "horizon_bucket_grid",
    "trace_key_space",
    "compile_bound",
    "format_trace_key_diff",
]
