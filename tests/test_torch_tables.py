"""The paper's comparison path in the port on the CPU against the JAX
package: every pair of Table II and the hwsim pair through ``Model.forward``
and ``eval_metrics``, two of them through ``generate``, ``perplexity`` and
the continuous engine; smokes of Tables I, II and III,
Fig. 5 and the normalization-error study; Table III's LUT bytes and
latency column against the reference's.

Same numpy weights (``convert.py``) and the same numpy tokens on both sides,
float32.  The reference's hwsim runs under ``jax.experimental.enable_x64``,
which the installed JAX lacks; this module's tests alias it to
``jax.enable_x64`` while they run (``x64_alias``; the reference is not
edited, and its own tests still see JAX as it is).  Tolerances, with what was
measured when they were set:
  * logits of reduced gpt-neo-1.3b under each pair: 1e-5 (|logit| < 1;
    measured <= 2.7e-7, the hwsim pair bitwise);
  * ``eval_metrics`` perplexity: 1e-5 relative, and 1e-4 for the hwsim
    pair, whose integer grids (Δ steps of a whole logit, Q8.8 inputs) turn
    one ulp of a score or an activation into a whole step: on the tiny
    backbone's first held-out batch one such flip at one position changes
    34 of 1024 positions' logits (one sequence, from there on) and the
    perplexity by 1.1e-5 relative, every other position bitwise; top-1
    within 2 of the batch's 1008 targets;
  * the continuous engine (2 slots, chunk 4, block 4, the reference's mixed
    workload): greedy tokens identical with the sentinels off; with them on
    (the default) the counters, completions and event logs equal.  Both
    engines fail every request there: Softermax's Σp residual is ~1e-2,
    far past the (t + 1)·4ε bound, and the hwsim LayerNorm's σ residual on
    the random-weight activations (~0.02, a few Q8.8 steps) is past the
    head's 1e-3 bound; the retry budget then runs out.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.data.synthetic import DataConfig, batch_at
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.benchmarks import (common, fig5_norm_error, norm_error_study,
                                    table1_accuracy, table2_score_tasks, table3_hw_cost)
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import synthetic
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate, perplexity
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference's benchmarks/ package
    sys.path.insert(0, str(ROOT))
from benchmarks import common as jax_common  # noqa: E402
from benchmarks import table3_hw_cost as jax_table3  # noqa: E402


PAIRS = {**table2_score_tasks.METHODS, "FP32": ("exact", "exact_ln"),
         "FP32+Ours(hwsim)": ("gn_hwsim", "gn_ln_hwsim")}
LOGITS_ATOL = 1e-5
PPL_RTOL = {"FP32+Ours(hwsim)": 1e-4}  # else 1e-5
ENGINE_KEYS = ("sentinel_checks", "sentinel_violations", "quarantined_blocks", "retries",
               "fallbacks", "table_repairs", "failed_completions", "generated_tokens",
               "read_path")
LENS = [5, 9, 14, 22, 7]  # the reference's _mixed_requests (tests/test_serve_paged.py)


@pytest.fixture(autouse=True, scope="module")
def x64_alias():
    """The reference's ``jax.experimental.enable_x64``, which the installed
    JAX lacks, aliased to ``jax.enable_x64`` while this module's tests run
    and removed after, so the JAX package's own tests see JAX as it is."""
    had, old = hasattr(jax.experimental, "enable_x64"), getattr(jax.experimental,
                                                                 "enable_x64", None)
    jax.experimental.enable_x64 = jax.enable_x64
    yield
    if had:
        jax.experimental.enable_x64 = old
    else:
        del jax.experimental.enable_x64


def _pair(arch, sm, nm, **over):
    over = {"dtype": "float32", "softmax_impl": sm, "norm_impl": nm, **over}
    jmodel = jax_make_model(jax_reduce_config(jax_get_config(arch), **over))
    tmodel = make_model(reduce_config(get_config(arch), **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, tmodel, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("label", list(PAIRS))
def test_forward_logits_match_jax(label):
    sm, nm = PAIRS[label]
    jmodel, jparams, tmodel, npp = _pair("gpt-neo-1.3b", sm, nm)
    params = tmodel.prepare(params_from_numpy(tmodel, npp, device="cpu"), "cpu")
    toks = np.random.default_rng(3).integers(0, 256, size=(2, 24)).astype(np.int32)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_ATOL)
    assert np.abs(np.asarray(want)).max() < 1


def test_eval_metrics_perplexity_matches_jax(monkeypatch):
    """The port's ``eval_metrics`` against the reference's on the port's
    token arrays (patched into the reference's ``batch_at``), the tiny
    backbone's weights from the reference's init, every pair."""
    cfg = common.tiny_cfg()
    jcfg = jax_common.tiny_cfg()
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(make_model(cfg), jax.tree.map(np.asarray, jparams), device="cpu")
    monkeypatch.setattr(jax_common, "batch_at", lambda data, seed: {
        "tokens": jnp.asarray(synthetic.batch_at(common.TINY_DATA, seed)["tokens"])})
    for label, (sm, nm) in PAIRS.items():
        got = common.eval_metrics(common.with_impls(cfg, sm, nm), params, n_batches=1)
        want = jax_common.eval_metrics(jax_common.with_impls(jcfg, sm, nm), jparams,
                                       n_batches=1)
        rtol = PPL_RTOL.get(label, 1e-5)
        assert got["perplexity"] == pytest.approx(want["perplexity"], rel=rtol), label
        assert got["top1_acc"] == pytest.approx(want["top1_acc"], abs=2 / 1008), label


@pytest.mark.parametrize("pair", [("softermax", "exact_ln"), ("gn_hwsim", "gn_ln_hwsim")],
                         ids=["softermax", "hwsim"])
def test_generate_and_perplexity_match_jax(pair):
    """The static path under a one-pass-only pair: greedy ``generate``
    (prefill, then slab decode steps) identical to the JAX package's, and
    ``perplexity`` within PPL_RTOL of the reference's formula."""
    jmodel, jparams, tmodel, npp = _pair("gpt-neo-1.3b", *pair)
    params = tmodel.prepare(params_from_numpy(tmodel, npp, device="cpu"), "cpu")
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 12)).astype(np.int32)
    want = jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks[:, :6])},
                        JaxServeConfig(max_new_tokens=5))
    got = generate(tmodel, params, {"tokens": toks[:, :6]}, ServeConfig(max_new_tokens=5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, jnp.asarray(toks[:, 1:, None]), -1)
    assert perplexity(tmodel, params, {"tokens": toks}) == pytest.approx(
        float(jnp.exp(nll.mean())), rel=1e-5)


def _prompt(vocab, length, seed):
    data = DataConfig(vocab=vocab, seq_len=length, global_batch=1, seed=seed)
    return np.asarray(batch_at(data, 0)["tokens"][0], np.int32)


@pytest.mark.parametrize("sentinels", [True, False], ids=["sentinels", "plain"])
@pytest.mark.parametrize("pair", [("softermax", "exact_ln"), ("gn_hwsim", "gn_ln_hwsim")],
                         ids=["softermax", "hwsim"])
def test_continuous_engine_matches_jax(pair, sentinels):
    """Both engines read through the gathered path (the reference's
    fallback for a one-pass-only softmax) and give the same greedy tokens,
    completions, counters and event log."""
    jmodel, jparams, tmodel, npp = _pair("gpt-neo-1.3b", *pair)
    vocab = tmodel.cfg.vocab
    jreqs = [JaxRequest(id=i, tokens=_prompt(vocab, n, 300 + i), max_new_tokens=4,
                        arrival_step=i) for i, n in enumerate(LENS)]
    treqs = [Request(id=i, tokens=_prompt(vocab, n, 300 + i), max_new_tokens=4,
                     arrival_step=i) for i, n in enumerate(LENS)]
    kw = {"num_slots": 2, "max_seq": required_max_seq(treqs), "chunk": 4, "block_size": 4,
          "sentinels": sentinels}
    jeng = JaxEngine(jmodel, jparams, cfg=JaxServeConfig(), **kw)
    teng = ContinuousEngine(tmodel, params_from_numpy(tmodel, npp, device="cpu"),
                            cfg=ServeConfig(), device="cpu", **kw)
    done = {}
    for name, eng, reqs in (("jax", jeng, jreqs), ("port", teng, treqs)):
        done[name] = {c.request_id: (c.new_tokens.tolist(), c.finish_reason)
                      for c in eng.run(reqs)}
    assert done["port"] == done["jax"]
    jm, tm = jeng.metrics(), teng.metrics()
    assert {k: tm[k] for k in ENGINE_KEYS} == {k: jm[k] for k in ENGINE_KEYS}
    assert tm["read_path"] == "gathered"
    assert teng.event_log == jeng.event_log
    if sentinels:
        assert tm["failed_completions"] == len(LENS) and tm["sentinel_violations"] > 0
    else:
        assert tm["generated_tokens"] == 4 * len(LENS)


# ------------------------------------------------------------------ tables --
@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One 3-step training of the tiny backbone, shared by the tables: the
    first Table I run, which trains it (its root and rows)."""
    root = tmp_path_factory.mktemp("tables")
    return root, table1_accuracy.run(steps=3, device="cpu", root=root)


@pytest.fixture(scope="module")
def tiny_root(tiny_run):
    return tiny_run[0]


def test_table1_and_table2_smoke(tiny_run):
    """Table I trains once and caches the checkpoint: a second run loads it
    (no training, the same FP32 row); Table II on the same checkpoint."""
    tiny_root, first = tiny_run
    assert set(table1_accuracy.ROWS) <= set(first) and first["train_seconds"] > 0
    base = first["FP32"]
    assert base["ppl_delta_%"] == 0.0 == base["acc_delta_%"]
    for label in table1_accuracy.ROWS:
        assert np.isfinite(first[label]["perplexity"]) and 0 <= first[label]["top1_acc"] <= 1
    assert store.latest_step(tiny_root / "tiny_lm") == 3
    assert common.tiny_cfg().softmax_impl == "exact" and common.tiny_cfg().d_model == 128
    t1 = table1_accuracy.run(steps=3, device="cpu", root=tiny_root)
    assert t1["train_seconds"] == 0.0  # the shared checkpoint, not a second training
    assert t1["FP32"] == first["FP32"]
    assert set(table1_accuracy.ROWS) == {"FP32", "FP32+Ours", "FP32+Ours(hwsim)"}
    assert table1_accuracy.ROWS["FP32+Ours(hwsim)"] == ("gn_hwsim", "gn_ln_hwsim")
    t2 = table2_score_tasks.run(steps=3, device="cpu", root=tiny_root)
    assert list(t2) == ["FP32", *table2_score_tasks.METHODS]
    assert t2["FP32"]["ppl_drop_%"] == 0.0
    for key in ("perplexity", "top1_acc"):
        assert t2["FP32"][key] == t1["FP32"][key]
    for rows in (t1, t2):
        for label, m in rows.items():
            if isinstance(m, dict):
                assert np.isfinite(m["perplexity"]) and 0 <= m["top1_acc"] <= 1, label
    assert t2["Proposed(GN)"]["perplexity"] == pytest.approx(t1["FP32+Ours"]["perplexity"])
    for name in ("table1_accuracy", "table2_score_tasks"):
        assert (tiny_root / "results" / f"{name}.json").exists()


def test_fig5_smoke(tiny_root):
    out = fig5_norm_error.run(steps=3, device="cpu", root=tiny_root, n_batches=1)
    assert list(out["softmax"]) == list(fig5_norm_error.SOFTMAXES)
    assert list(out["layernorm"]) == list(fig5_norm_error.NORMS)
    sm, ln = out["softmax"], out["layernorm"]
    for h in (*sm.values(), *ln.values()):
        assert abs(sum(h["fraction"]) - 1) < 1e-9
    # the GN rows below the edges the chip run gates on, the baselines far past
    for fam, edges in fig5_norm_error.GN_EDGES.items():
        for name, edge in edges.items():
            assert out[fam][name]["max"] < edge, (fam, name, out[fam][name]["max"])
    assert min(sm[n]["max"] for n in ("softermax", "pseudo", "log_domain")) > 1e-3
    assert min(ln[n]["max"] for n in ("integer_ln", "lut_ln")) > 1e-3


def test_table3_smoke_and_reference_columns(tiny_root, monkeypatch):
    """The port's census against the reference's (its writeout patched to
    write nothing): the LUT bytes and the latency column equal; the
    multiplier, divider, exponential and square-root columns zero or not
    alike, but for the differences ``PERF.md`` explains: the port's GN
    softmax reads its ROM by index where the reference computes the
    entries with ``exp``, and ``aten.mean`` folds the division by the row
    length that ``jnp.mean`` spells as ``div``."""
    monkeypatch.setattr(jax_table3, "writeout", lambda name, payload: payload)
    ref = jax_table3.run()
    got = table3_hw_cost.run(device="cpu", root=tiny_root)
    assert set(got) == set(ref)
    explained = {("softmax/gn", "exp_ops"), ("norm/exact_ln", "div_ops"),
                 ("norm/gn_ln", "div_ops")}
    for row, m in ref.items():
        if row == "paper_reference_um2":
            assert got[row] == m
            continue
        assert got[row]["lut_bytes"] == m["lut_bytes"]
        assert got[row]["latency_cycles"] == m["latency_cycles"]
        assert got[row]["area_proxy"] > 0
        for col in ("mul_ops", "div_ops", "exp_ops", "sqrt_ops"):
            if col in m and (row, col) not in explained:
                assert (got[row][col] > 0) == (m[col] > 0), (row, col)
    assert got["softmax/gn"]["exp_ops"] == 0 and got["norm/gn_ln"]["sqrt_ops"] == 0
    assert got["norm/gn_ln"]["div_ops"] == 0 and got["softmax/exact"]["exp_ops"] > 0


def test_norm_error_study_smoke():
    out = norm_error_study.run(device="cpu", rows=64)
    assert all(r["ok"] for r in out["paged"].values())
    assert set(out["fig2"]) == set(norm_error_study.FRAC_BITS)
    # the approximation falls with the LUT while Σp stays pinned near 1
    errs = [out["fig2"][f]["max_abs_p_err"] for f in norm_error_study.FRAC_BITS]
    assert errs == sorted(errs, reverse=True)
    assert max(r["max_norm_err"] for r in out["fig2"].values()) < 1e-5
    assert out["softermax"][4] > out["softermax"][10] > 1e-3
    assert norm_error_study.main(["--device", "cpu", "--rows", "16"])["paged"]["int8"]["ok"]
