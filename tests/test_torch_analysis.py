"""The port's invariant auditor and lint (``repro_torch.analysis``) against
the reference's (``repro.analysis``), on the CPU.

* The rule ids are the reference's, every rule has fixtures, every lint
  rule flags its bad torch source and passes its good twin, every audit
  rule flags its bad torch fixture and passes its good one; the CLI's
  ``--self-check`` is green, ``--break-invariant`` exits non-zero naming
  each of the 14 rules, ``--lint`` over the port is clean, and the
  ``--json`` report round-trips.
* ``audit_arch`` finds nothing at the smoke size for dense (internlm2-1.8b,
  every forced read path and the int8 pool), MLA (minicpm3-4b), MoE
  (llama4-scout-17b-a16e), the slab pool (mixtral-8x22b) and an SSM arch
  (xlstm-350m).
* A-GATHER's counts equal the reference's ``GATHER_BUDGETS`` wherever the
  designs match (the kernel 0, the dense streamed read 1, the gathered
  reads 2) and the port's own budget where they do not (MLA's streamed
  read: 2 against the reference's 0, ``audit.GATHER_BUDGETS`` says why);
  the kernel's opaque record keeps its plain version's two stream gathers
  a layer out of the count.
* A sharded engine (two shards of the CPU): Pass A walks every shard's
  ticks and finds nothing, and a tick takes one device->host copy a shard
  (``audit.dtoh_budget``).
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from repro.analysis.audit import GATHER_BUDGETS as REF_BUDGETS
from repro.analysis.rules import ALL_RULES as REF_RULES
from repro.analysis.rules import AUDIT_RULES as REF_AUDIT
from repro.analysis.rules import LINT_RULES as REF_LINT
from repro_torch.analysis import audit, lint
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.fixtures import AUDIT_FIXTURES
from repro_torch.analysis.op_walk import OpRecorder
from repro_torch.analysis.rules import ALL_RULES, AUDIT_RULES, LINT_RULES
from repro_torch.models import attention
from repro_torch.serve import engine as engine_mod

DENSE, MLA = "internlm2-1.8b", "minicpm3-4b"
# the reference's name for each of the port's read paths
REF_PATH = {"kernel": "pallas", "streamed": "streamed", "gathered": "gathered"}


# ---------------------------------------------------------------- rules ---
def test_rule_ids_are_the_references_and_have_fixtures():
    assert set(ALL_RULES) == set(REF_RULES)
    assert set(AUDIT_RULES) == set(REF_AUDIT) and set(LINT_RULES) == set(REF_LINT)
    for rule in LINT_RULES.values():
        assert rule.bad_fixture and rule.good_fixture, rule.id
        assert rule.severity == REF_RULES[rule.id].severity
    assert set(AUDIT_FIXTURES) == set(AUDIT_RULES)


@pytest.mark.parametrize("rule_id", sorted(LINT_RULES))
def test_lint_rule_flags_bad_and_passes_good(rule_id):
    rule = LINT_RULES[rule_id]
    bad = lint.lint_source(rule.bad_fixture, f"{rule_id}:bad")
    good = lint.lint_source(rule.good_fixture, f"{rule_id}:good")
    assert any(f.rule == rule_id for f in bad), f"{rule_id} is blind"
    assert not any(f.rule == rule_id for f in good), f"{rule_id} false-positives"


@pytest.mark.parametrize("rule_id", sorted(AUDIT_FIXTURES))
def test_audit_rule_flags_bad_and_passes_good(rule_id):
    bad_fn, good_fn = AUDIT_FIXTURES[rule_id]
    bad, good = bad_fn(), good_fn()
    assert any(f.rule == rule_id for f in bad), f"{rule_id} is blind"
    assert good == [], f"{rule_id} false-positives: {[f.format() for f in good]}"


def test_lint_finds_tick_bodies_and_bites_on_the_engine():
    """The engine's tick body is found at its StepGraphs.run call site
    (the graph key's names static), and a host sync or a rebound cache
    leaf planted in it is flagged."""
    text = Path(engine_mod.__file__).read_text()
    assert lint.FileLinter("engine.py", text).index.bodies["_tick"] >= {"kind"}
    anchor = "        pos = torch.where(active, self._pos_dev, 0).to(torch.int32)\n"
    assert anchor in text
    planted = text.replace(anchor, anchor + "        if int(pos.sum()) > 0:\n"
                                            "            self.pool.cache = {}\n")
    rules = {f.rule for f in lint.lint_source(planted, "engine.py")}
    assert {"L-TRACED-BRANCH", "L-TRACED-CAST", "L-DONATED-REBIND"} <= rules


# ------------------------------------------------------------------ CLI ---
def test_cli_lint_port_clean(capsys):
    assert cli_main(["--lint", "src/repro_torch"]) == 0
    assert "ok=True" in capsys.readouterr().out


def test_cli_self_check_green():
    assert cli_main(["--self-check"]) == 0


@pytest.mark.parametrize("rule_id", sorted(ALL_RULES))
def test_cli_break_invariant_nonzero_with_rule_id(rule_id, capsys):
    rc = cli_main(["--break-invariant", rule_id])
    out = capsys.readouterr().out
    assert rc != 0, f"{rule_id}: breaking the invariant must fail the gate"
    assert rule_id in out


def test_cli_json_report_round_trips(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert cli_main(["--self-check", "--json", str(path)]) == 0
    capsys.readouterr()
    d = json.loads(path.read_text())
    assert d["ok"] is True and d["passes"] == ["self-check"]
    assert set(d["self_check"]) == set(ALL_RULES)
    assert all(v == "ok" for v in d["self_check"].values())


def test_cli_unknown_rule_errors():
    with pytest.raises(SystemExit):
        cli_main(["--break-invariant", "NO-SUCH-RULE"])


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule_id in out for rule_id in ALL_RULES)


# ------------------------------------------------- end-to-end arch audit --
@pytest.mark.parametrize("arch,tier", [
    (DENSE, "full"),                     # kernel read + streamed, gathered, int8
    (MLA, "full"),                       # streamed latents + gathered, int8
    ("llama4-scout-17b-a16e", "default"),  # MoE over the kernel read
    ("mixtral-8x22b", "default"),        # the slab pool (a sliding window)
    ("xlstm-350m", "default"),           # SSM carries on the slab pool
])
def test_audit_arch_clean_on_cpu(arch, tier):
    findings = audit.audit_arch(arch, tier=tier, device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)


def _widest_tick(arch: str, path: str | None, opaque_kernels: bool = True):
    """(whole-stream arena gathers, layers, read path) of one engine's
    parked fused tick at its widest bucket, its read forced to ``path``."""
    prev = attention.FORCE_PAGED_READ
    attention.FORCE_PAGED_READ = path
    try:
        engine, _ = audit.build_engine(arch, device="cpu")
    finally:
        attention.FORCE_PAGED_READ = prev
    bucket = max(engine.horizon_bucket_grid)
    assert bucket > attention.STREAM_TILE
    ep = audit.collect_entry_points(engine, [("fused", bucket)])[0]
    out, records, before, after = audit.record_entry_point(ep, opaque_kernels=opaque_kernels)
    kv = {k: after[k] for k in ep.kv_leaves}
    hits = audit.stream_gather_hits(records, kv, engine.num_slots * bucket)
    return hits, engine.model.cfg.n_layers, engine.read_path


@pytest.mark.parametrize("arch,path", [(DENSE, None), (DENSE, "streamed"), (DENSE, "gathered"),
                                       (MLA, None), (MLA, "gathered")])
def test_gather_counts_against_reference_budgets(arch, path):
    hits, layers, read = _widest_tick(arch, path)
    mla = arch == MLA
    budget, why = audit.GATHER_BUDGETS[(read, mla)]
    assert len(hits) == budget * layers, hits
    ref = REF_BUDGETS[(REF_PATH[read], mla)]
    if (read, mla) == ("streamed", True):
        # the port gathers each latent arena once over the horizon
        assert (ref, budget) == (0, 2) and "reference" in why
    else:
        assert budget == ref


def test_opaque_kernel_records_hide_the_plain_reads_gathers():
    """The kernel read on the CPU runs its plain version, which gathers K
    and V over the whole stream; the opaque record keeps them out."""
    hits, layers, read = _widest_tick(DENSE, None)
    assert read == "kernel" and hits == []
    plain, _, _ = _widest_tick(DENSE, None, opaque_kernels=False)
    assert len(plain) == 2 * layers, plain


def test_recorder_records_each_kernel_call_once_with_its_work():
    """One opaque record a kernel call, carrying its work."""
    engine, reqs = audit.build_engine(DENSE, device="cpu")
    engine.run(reqs)
    ep = audit.collect_entry_points(engine, [("decode", max(engine.horizon_bucket_grid))])[0]
    with OpRecorder() as rec:
        ep.call()
    kernels = [r for r in rec.records if r.opaque]
    names = [r.name for r in kernels]
    layers = engine.model.cfg.n_layers
    assert names.count("gn_paged_attention") == layers
    assert all(r.work is not None and r.work.bytes > 0 for r in kernels)


def test_trace_keys_on_cpu_want_no_captures():
    engine, reqs = audit.build_engine(DENSE, device="cpu")
    engine.run(reqs)
    assert audit.audit_trace_keys(engine, "cpu") == []
    m = dict(engine.metrics(), fused_step_compilations=1)
    found = audit.check_trace_keys(m, "cpu", paged=True, captures=False,
                                   max_seq=engine.max_seq, block_size=engine.pool.block_size,
                                   engine_grid=engine.horizon_bucket_grid)
    assert [f.rule for f in found] == ["A-TRACEKEY"]


# ----------------------------------------------------------- two shards ---
def test_audit_walks_every_shard_of_a_sharded_engine():
    """Pass A over a two-shard engine at the smoke size (every read path and
    the int8 pool): nothing found, each shard's entry points recorded."""
    assert audit.audit_arch(DENSE, tier="full", device="cpu", devices=2) == []
    engine, reqs = audit.build_engine(DENSE, device="cpu", devices=2)
    engine.run(reqs)
    names = [ep.name for ep in audit.collect_entry_points(engine)]
    for shard in ("@0", "@1"):
        mine = [n for n in names if n.endswith(shard)]
        assert "prefix_cow_fork" + shard in mine and any(n.startswith("sentinel") for n in mine)
    assert len(names) == 2 * len({n.rsplit("@", 1)[0] for n in names})


@pytest.mark.parametrize("devices", [1, 2])
def test_one_device_to_host_copy_a_shard_a_tick(devices, monkeypatch):
    """``step`` takes one ``.cpu()`` copy a shard a model tick (its tokens and
    health words), the budget ``dtoh_budget`` gives the card's profiled
    window."""
    engine, reqs = audit.build_engine(DENSE, device="cpu", devices=devices)
    for r in reqs:
        engine.submit(r)
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(1) or real(
        t, *a, **k))
    before = engine.model_ticks
    while engine.step():
        pass
    ticks = engine.model_ticks - before
    assert ticks > 0 and len(copies) == audit.dtoh_budget(engine, ticks) == devices * ticks
