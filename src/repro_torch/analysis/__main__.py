"""CLI of the invariant auditor and the lint (the port's counterpart of
``python -m repro.analysis``).

    python -m repro_torch.analysis --all --device cpu     # the gate, on the CPU
    python -m repro_torch.analysis --audit --archs internlm2-1.8b,minicpm3-4b
    python -m repro_torch.analysis --lint src/repro_torch chip_smoke.py
    python -m repro_torch.analysis --self-check           # fixtures still bite
    python -m repro_torch.analysis --break-invariant A-GATHER
    python -m repro_torch.analysis --all --device cpu --json findings.json

The audit's smoke engines run on the card unless ``--device cpu``; the lint
and the fixtures need no device.  Exit code 0 iff no error-severity
finding (warnings report but pass).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import resolve_device
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.rules import ALL_RULES, LINT_RULES

DEFAULT_LINT_PATHS = ["src/repro_torch"]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_self_check() -> tuple[list[Finding], dict]:
    """Every rule must flag its bad fixture and pass its good twin."""
    from repro_torch.analysis.fixtures import AUDIT_FIXTURES

    findings: list[Finding] = []
    results: dict[str, str] = {}
    for rule_id, rule in LINT_RULES.items():
        bad = lint_mod.lint_source(rule.bad_fixture, f"fixture:{rule_id}:bad")
        good = lint_mod.lint_source(rule.good_fixture, f"fixture:{rule_id}:good")
        bad_hit = any(f.rule == rule_id for f in bad)
        good_hit = any(f.rule == rule_id for f in good)
        results[rule_id] = "ok" if bad_hit and not good_hit else "BROKEN"
        if not bad_hit:
            findings.append(Finding(rule_id, "error", f"fixture:{rule_id}:bad",
                                    "rule did not flag its known-bad fixture (rule is blind)"))
        if good_hit:
            findings.append(Finding(rule_id, "error", f"fixture:{rule_id}:good",
                                    "rule flagged its known-good twin (false positive)"))
    for rule_id, (bad_fn, good_fn) in AUDIT_FIXTURES.items():
        bad_hit = any(f.rule == rule_id for f in bad_fn())
        good = good_fn()
        results[rule_id] = "ok" if bad_hit and not good else "BROKEN"
        if not bad_hit:
            findings.append(Finding(rule_id, "error", f"fixture:{rule_id}:bad",
                                    "audit did not flag its known-bad fixture (rule is blind)"))
        for f in good:
            findings.append(Finding(rule_id, "error", f"fixture:{rule_id}:good",
                                    f"audit flagged the known-good twin: {f.message}"))
    return findings, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="op-trace invariant auditor + CUDA-graph-hazard lint")
    ap.add_argument("--all", action="store_true",
                    help="audit the full registry + lint + self-check (the gate)")
    ap.add_argument("--audit", action="store_true", help="run Pass A")
    ap.add_argument("--lint", action="store_true", help="run Pass B")
    ap.add_argument("--self-check", action="store_true",
                    help="run every rule against its bad/good fixtures")
    ap.add_argument("--break-invariant", metavar="RULE",
                    help="feed RULE's known-bad fixture through the real pipeline (must exit "
                         "non-zero with that rule id)")
    ap.add_argument("--archs", default="", help="comma-separated registry archs (default: all)")
    ap.add_argument("--tier", choices=("default", "full"), default="full",
                    help="'full' adds the other forced read paths and the int8 pool per "
                         "paged arch")
    ap.add_argument("--device", default=None,
                    help="device of the audit's engines (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("paths", nargs="*",
                    help=f"lint paths (default: {' '.join(DEFAULT_LINT_PATHS)})")
    ap.add_argument("--json", metavar="FILE", help="write the findings report")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES.values():
            print(f"{rule.id:20s} {rule.pass_name:5s} {rule.severity:7s} {rule.summary}")
        return 0

    report = Report()

    if args.break_invariant:
        rule_id = args.break_invariant
        if rule_id not in ALL_RULES:
            ap.error(f"unknown rule {rule_id!r} (see --list-rules)")
        report.passes.append(f"break-invariant:{rule_id}")
        if rule_id in LINT_RULES:
            found = lint_mod.lint_source(LINT_RULES[rule_id].bad_fixture,
                                         f"fixture:{rule_id}:bad")
        else:
            from repro_torch.analysis.fixtures import run_fixture
            found = run_fixture(rule_id, "bad")
        report.extend(found)
        hit = any(f.rule == rule_id for f in found)
        if not hit:
            report.extend([Finding(rule_id, "error", f"fixture:{rule_id}:bad",
                                   "fixture did NOT trigger its rule: the audit is blind")])
        _finish(report, args)
        return 1 if hit or not report.ok else 0  # a broken invariant exits non-zero

    if args.all:
        args.audit = args.lint = args.self_check = True
    if not (args.audit or args.lint or args.self_check):
        ap.error("nothing to do: pass --all, --audit, --lint or --self-check")

    if args.lint:
        report.passes.append("lint")
        findings, n = lint_mod.lint_paths(args.paths or DEFAULT_LINT_PATHS)
        report.extend(findings)
        report.linted_files = n
        _log(f"lint: {n} files, {len(findings)} findings")

    if args.self_check:
        report.passes.append("self-check")
        findings, results = run_self_check()
        report.extend(findings)
        report.self_check = results
        broken = [r for r, v in results.items() if v != "ok"]
        _log(f"self-check: {len(results)} rules, "
             + (f"BROKEN: {broken}" if broken else "all fixtures bite"))

    if args.audit:
        from repro_torch.analysis.audit import run_audit

        report.passes.append("audit")
        archs = [a for a in args.archs.split(",") if a] or None
        findings, audited = run_audit(archs, tier=args.tier,
                                      device=resolve_device(args.device), log=_log)
        report.extend(findings)
        report.audited_archs = audited

    _finish(report, args)
    return 0 if report.ok else 1


def _finish(report: Report, args) -> None:
    for f in report.findings:
        print(f.format())
    d = report.to_dict()
    print(f"passes={','.join(report.passes)} findings={d['num_findings']} "
          f"errors={d['num_errors']} ok={report.ok}")
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(report.to_json())
        _log(f"report written to {args.json}")


if __name__ == "__main__":
    sys.exit(main())
