"""The port's continuous engine over MLA latent arenas on the CPU against the
JAX engine: reduced minicpm3-4b at f32, the JAX weights through
``convert.py``, 2 slots, chunk 4, sentinels on (both engines' default),
both on the streamed read (the MLA read of both packages); the fp pool at
block size 8 and the int8 pool at block size 4 (the reference's two block
sizes, chunk and 2 x chunk).

  * the reference's mixed workload (tests/test_serve_paged.py: 5 prompts of
    5..22 tokens, 4 new, one arrival a tick) over fp and int8 latent pools
    (tests/test_serve_quant.py): greedy tokens, ``event_log``, completions
    and the shared ``metrics()`` keys equal the JAX engine's; the fp tokens
    equal the port's static oracle; the pool drained; a reset replay equal;
  * the sentinels (tests/test_serve_faults.py: 3 prompts of 5, 9, 7 tokens,
    6 new, max_seq 64): a clean run silent, and ``nan_tile`` (fp), ``scale``
    (int8) and ``table`` (fp) faults from the injector's seed 1: the same
    fault records, ``event_log``, counters, quarantined blocks and tokens
    as the JAX engine's, the tokens the clean run's.

The JAX engines are built once per pool and reset between workloads (the
reset keeps their compiled ticks).
"""
import numpy as np
import pytest

from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.models import attention as t_attn
from repro_torch.serve.engine import ServeConfig, static_reference
from repro_torch.serve.faults import FaultInjector

from _torch_parity import (CHUNK, COMPLETION_KEYS, FAMILIES, OWN, jax_engine, pair, port_engine,
                           prompt, to_port)

LENS = [5, 9, 14, 22, 7]
MAX_SEQ = 64
BLOCK = {"fp": 2 * CHUNK, "int8": CHUNK}
FAULTS = (("nan_tile", "fp"), ("table", "fp"), ("scale", "int8"))
SENTINEL_KEYS = ("sentinel_checks", "sentinel_violations", "quarantined_blocks", "retries",
                 "fallbacks", "table_repairs", "failed_completions", "preempt_resumes")


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None


def _mixed(vocab):
    return [JaxRequest(id=i, tokens=prompt(vocab, n, 300 + i), max_new_tokens=4,
                       arrival_step=i) for i, n in enumerate(LENS)]


def _fault_reqs(vocab):
    """The reference fault tests' workload."""
    rng = np.random.default_rng(0)
    return [JaxRequest(id=i, tokens=rng.integers(0, vocab, size=n).astype(np.int32),
                       max_new_tokens=6) for i, n in enumerate((5, 9, 7))]


def _drive(eng, inj, kind, reqs, n_faults=2):
    """Submit, then step to the drain, injecting ``kind`` after each tick
    until ``n_faults`` took (the reference test's loop)."""
    for r in reqs:
        eng.submit(r)
    records = []
    while eng.step():
        if len(records) < n_faults:
            rec = inj.inject(kind)
            if rec is not None:
                records.append(rec)
    return [(r.kind, r.step, r.slot, r.block, r.layer, r.leaf, r.value, r.detectable)
            for r in records]


def _summary(eng, records=None) -> dict:
    m = eng.metrics()
    return {"tokens": {c.request_id: np.asarray(c.new_tokens).tolist() for c in eng.completions},
            "events": [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
                       for e in eng.event_log],
            "completions": {c.request_id: {k: getattr(c, k) for k in COMPLETION_KEYS}
                            for c in eng.completions},
            "metrics": m, "quarantined": set(int(b) for b in eng.pool.quarantined),
            "records": records}


@pytest.fixture(scope="module")
def mla():
    jmodel, jparams, model, master = pair(FAMILIES["mla"])
    vocab = jmodel.cfg.vocab
    runs = {}
    for kv in ("fp", "int8"):
        eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=MAX_SEQ, block_size=BLOCK[kv],
                         kv_dtype=kv)
        assert eng.sentinels and eng.metrics()["read_path"] == "streamed"
        eng.run(_mixed(vocab))
        runs["mixed", kv] = _summary(eng)
        eng.reset()
        eng.run(_fault_reqs(vocab))
        runs["clean", kv] = _summary(eng)
        for kind, pool in FAULTS:
            if pool == kv:
                eng.reset()
                records = _drive(eng, JaxFaultInjector(eng, seed=1), kind, _fault_reqs(vocab))
                runs[kind] = _summary(eng, records)
    return {"model": model, "master": master, "vocab": vocab, "runs": runs}


def _port(mla, kv_dtype="fp"):
    return port_engine(mla["model"], mla["master"], num_slots=2, max_seq=MAX_SEQ,
                       block_size=BLOCK[kv_dtype], kv_dtype=kv_dtype)


def _assert_same(mine: dict, ref: dict) -> None:
    assert mine["tokens"] == ref["tokens"]
    assert mine["events"] == ref["events"]
    assert mine["completions"] == ref["completions"]
    shared = sorted((set(mine["metrics"]) & set(ref["metrics"])) - OWN)
    assert {k: mine["metrics"][k] for k in shared} == {k: ref["metrics"][k] for k in shared}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_mla_engine_equals_jax_engine(mla, kv_dtype):
    eng = _port(mla, kv_dtype)
    reqs = to_port(_mixed(mla["vocab"]))
    comps = eng.run(reqs)
    m = eng.metrics()
    assert m["read_path"] == "streamed" and m["kv_dtype"] == kv_dtype
    assert m["block_size"] == BLOCK[kv_dtype]
    _assert_same(_summary(eng), mla["runs"]["mixed", kv_dtype])
    assert all(c.finish_reason == "length" for c in comps)
    assert eng.pool.blocks_in_use == 0 and eng.pool.num_free == eng.pool.num_slots
    # the latent arenas: (L, nb + 1, bs, width), scales beside them for int8
    widths = {"c_kv": mla["model"].cfg.mla.kv_lora_rank,
              "k_rope": mla["model"].cfg.mla.qk_rope_head_dim}
    assert {k: v.shape[-1] for k, v in eng.pool.caches[0].items() if k in widths} == widths
    assert sorted(eng.pool.caches[0]) == sorted(
        list(widths) + ([f"{k}_scale" for k in widths] if kv_dtype == "int8" else []))
    if kv_dtype == "fp":
        oracle = static_reference(mla["model"], eng.params, reqs, ServeConfig())
        assert all(np.array_equal(c.tokens, oracle[c.request_id]) for c in comps)
    first = _summary(eng)["tokens"]
    eng.reset()
    eng.run(reqs)
    assert _summary(eng)["tokens"] == first


def test_mla_clean_run_silent(mla):
    eng = _port(mla)
    eng.run(to_port(_fault_reqs(mla["vocab"])))
    got, want = _summary(eng), mla["runs"]["clean", "fp"]
    _assert_same(got, want)
    m = got["metrics"]
    assert m["sentinel_checks"] > 0
    assert all(m[k] == 0 for k in SENTINEL_KEYS if k != "sentinel_checks")
    # the streamed read's full Σp probe: a residual, far under its bound
    assert 0.0 < m["sentinel_peak_sum_residual"] < 1e-4


@pytest.mark.parametrize("kind,kv_dtype", FAULTS)
def test_mla_fault_detected_contained_recovered_as_jax(mla, kind, kv_dtype):
    eng = _port(mla, kv_dtype)
    records = _drive(eng, FaultInjector(eng, seed=1), kind, to_port(_fault_reqs(mla["vocab"])))
    got, want = _summary(eng, records), mla["runs"][kind]
    assert got["records"] == want["records"] and len(records) == 2
    assert {r[5] for r in records} <= {"", "c_kv", "k_rope", "c_kv_scale", "k_rope_scale"}
    _assert_same(got, want)
    assert got["quarantined"] == want["quarantined"]
    m = got["metrics"]
    assert m["sentinel_violations"] > 0 and m["failed_completions"] == 0
    assert got["tokens"] == mla["runs"]["clean", "fp"]["tokens"]
    eng.pool.check_ledger()
