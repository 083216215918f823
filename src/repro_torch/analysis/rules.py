"""The rule registry (the port's counterpart of ``repro/analysis/rules.py``,
with the same rule ids): every auditor and lint rule with its id, severity
and summary, written for the port's mechanism (eager ticks captured into
CUDA graphs and replayed), and for each lint rule a known-bad torch source
it must flag and a known-good twin it must pass.

``--self-check`` runs each lint fixture through the real lint engine and
each audit fixture through the real audit checks (``fixtures.py``), so a
change that silently blinds a rule fails the same way a real violation
would.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    pass_name: str        # 'audit' | 'lint'
    severity: str         # 'error' | 'warning'
    summary: str
    bad_fixture: Optional[str] = None   # lint: source that must flag
    good_fixture: Optional[str] = None  # lint: twin that must pass


LINT_RULES: dict[str, Rule] = {}
AUDIT_RULES: dict[str, Rule] = {}


def _lint(rule: Rule) -> Rule:
    LINT_RULES[rule.id] = rule
    return rule


def _audit(rule: Rule) -> Rule:
    AUDIT_RULES[rule.id] = rule
    return rule


# ------------------------------------------------------------ Pass A ------
_audit(Rule(
    "A-GATHER", "audit", "error",
    "the paged tick gathers the whole bucketed block stream from an arena "
    "(aten index/index_select/gather/embedding with an arena storage as "
    "source) more often than its read path's budget (kernel 0, dense "
    "streamed 1, gathered 2, MLA 2: audit.GATHER_BUDGETS); a kernel's call "
    "is one opaque record, so its plain version's gathers never count",
))
_audit(Rule(
    "A-DONATE", "audit", "error",
    "a pool or cache leaf changed storage across a tick, or an op produced "
    "a tensor of a whole arena's or slab's shape outside the arena: the "
    "port's form of a dropped donation (a captured graph keeps reading the "
    "old buffer, or the tick copies the cache instead of writing in place)",
))
_audit(Rule(
    "A-F64", "audit", "error",
    "a float64/complex128 input or output of an op inside a tick (ticks "
    "compute in the model dtype and f32, never wider)",
))
_audit(Rule(
    "A-TRANSFER", "audit", "error",
    "a host sync or transfer inside a tick body: aten._local_scalar_dense "
    "(.item(), int(), bool() of a tensor), nonzero/masked_select, or a copy "
    "across devices; the staging uploads before the body and the one token "
    "copy after it are the boundary, and a replayed window on the card "
    "makes one device-to-host copy a tick",
))
_audit(Rule(
    "A-TRACEKEY", "audit", "error",
    "the engine captured a (step kind, horizon bucket) key outside the "
    "statically enumerated space, or its capture counts disagree with the "
    "keys it saw (bounded by the grid); on the CPU, where no graph is "
    "captured, the counts must be 0",
))
_audit(Rule(
    "A-QUANT", "audit", "error",
    "an int8-arena (kv_dtype=int8) tick holds a floating tensor of a whole "
    "arena's shape: the fp stream was materialized (or the arena upcast "
    "and then gathered) instead of dequantizing each gathered tile",
))
_audit(Rule(
    "A-SENTINEL", "audit", "error",
    "a sentinel tick's health output is not reachable, in the recorded "
    "ops' storage dataflow, from both the arenas and the tick's inputs: "
    "the GN probe is disconnected and corruption would read as healthy",
))


# ------------------------------------------------------------ Pass B ------
# A tick body is a function a ``StepGraphs.run`` call captures (its fn and
# warm-up arguments, resolved at the call site) or a model step method in
# ``lint.TICK_FUNCTIONS``; names in the graph key are fixed per capture.
_lint(Rule(
    "L-TRACED-BRANCH", "lint", "error",
    "Python if/while on a tensor's value inside a tick body (a host sync "
    "at capture, and a branch the replays never take again)",
    bad_fixture="""\
class Engine:
    def _tick(self, active, tokens):
        if active.any():
            return tokens + 1
        return tokens

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.active, self.tokens),
                                lambda: None)
""",
    good_fixture="""\
import torch


class Engine:
    def _tick(self, active, tokens):
        if tokens.shape[0] > 1 and active is not None:
            return torch.where(active[:, None], tokens + 1, tokens)
        return tokens

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.active, self.tokens),
                                lambda: None)
""",
))
_lint(Rule(
    "L-TRACED-CAST", "lint", "error",
    "int()/float()/bool(), .item(), .tolist(), .cpu() or .numpy() of a "
    "tensor inside a tick body (a host sync; a capture fails on it)",
    bad_fixture="""\
class Engine:
    def _tick(self, x, pos):
        return x[int(pos)]

    def step(self):
        return self._graphs.run(("decode",), lambda: self._tick(self.x, self.pos), lambda: None)
""",
    good_fixture="""\
class Engine:
    def _tick(self, x, pos):
        return x.index_select(0, pos.long().reshape(1))

    def step(self):
        return self._graphs.run(("decode",), lambda: self._tick(self.x, self.pos), lambda: None)
""",
))
_lint(Rule(
    "L-NP-TRACED", "lint", "error",
    "numpy called on a tensor inside a tick body (a silent host round "
    "trip: the replays keep the value the capture saw)",
    bad_fixture="""\
import numpy as np


class Engine:
    def _tick(self, x):
        return np.sum(x)

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.x), lambda: None)
""",
    good_fixture="""\
import numpy as np


class Engine:
    def _tick(self, x):
        return x.sum() * np.float32(2.0)

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.x), lambda: None)
""",
))
_lint(Rule(
    "L-STATIC-UNHASHABLE", "lint", "error",
    "a StepGraphs.run key holds an unhashable value (a list, dict or set): "
    "every call raises, or a key rebuilt per call never finds its graph",
    bad_fixture="""\
class Engine:
    def step(self, bucket):
        return self._graphs.run(("fused", [bucket]), self._tick, self._warm)
""",
    good_fixture="""\
class Engine:
    def step(self, bucket):
        return self._graphs.run(("fused", bucket), self._tick, self._warm)
""",
))
_lint(Rule(
    "L-MUT-DEFAULT", "lint", "error",
    "mutable default argument (shared across calls)",
    bad_fixture="""\
def admit(req, queue=[]):
    queue.append(req)
    return queue
""",
    good_fixture="""\
def admit(req, queue=None):
    queue = [] if queue is None else queue
    queue.append(req)
    return queue
""",
))
_lint(Rule(
    "L-DONATED-REBIND", "lint", "error",
    "a pool or cache leaf rebound inside a tick body (cache[k] = ..., "
    "self.arena = ...): the captured graph keeps the old buffer; write it "
    "in place (copy_, index_copy_)",
    bad_fixture="""\
class Engine:
    def _tick(self, x):
        self.cache["k"] = self.cache["k"] + x
        return x

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.x), lambda: None)
""",
    good_fixture="""\
class Engine:
    def _tick(self, x):
        self.cache["k"].add_(x)
        return x

    def step(self):
        return self._graphs.run(("fused",), lambda: self._tick(self.x), lambda: None)
""",
))
_lint(Rule(
    "L-UNUSED-IMPORT", "lint", "warning",
    "module-level import never used (outside __init__.py re-exports)",
    bad_fixture="""\
import os
import sys

def main():
    return sys.argv
""",
    good_fixture="""\
import sys

def main():
    return sys.argv
""",
))

ALL_RULES: dict[str, Rule] = {**AUDIT_RULES, **LINT_RULES}
