"""The port's GN runtime sentinels on the CPU against the JAX package: the
nonfinite-score repair of the GN softmax, the paged reads over poisoned
tiles, the probes, fault injection, quarantine and scrubbing, recompute
resume and the int8 -> fp fallback.

Reduced internlm2-1.8b at f32, weights through ``convert.py``; the workload
and injector seeds of the reference's tests/test_serve_faults.py (3 requests
of 5, 9, 7 tokens, 6 new tokens each, 2 slots, chunk 4, max_seq 64).
  * ``gn_softmax`` bit for bit the JAX one on rows with NaN, +-Inf and
    masked columns (XLA's f32 -> int32 cast, established here, sends NaN
    to 0 and saturates);
  * the plain paged read (the kernel read on the CPU) over a NaN or Inf K
    or V tile: per row, finite exactly where the JAX Pallas kernel (interpret
    mode) is finite, a tile named only by a stale table entry included, and
    within the reference's 2e-4 on every row that reads no poisoned block.
    Rows that read a poisoned K tile are finite in both but apart: the GN
    exponential launders the nonfinite scores, and the one-pass read and the
    online kernel launder them into different distributions;
  * forced to the streamed read, the reference's read on the CPU, with the
    injector seed of the JAX engine: the same fault records, ``event_log``,
    counters and quarantined set for ``nan_tile``, ``inf_tile``, ``scale``
    (int8) and ``table``, and tokens equal to the JAX static oracle's;
  * on the kernel read: V-tile faults flagged within one tick and recovered;
    K-tile faults flagged at the ticks where the JAX engine's streamed read
    (its default) flags them and recovered to the fault-free tokens, through
    the read's per-row flag of a nonfinite live score (a poisoned K tile
    leaves the output finite); ``bit_flip`` is the floor of every read;
  * a clean run silent; the sentinels off miss a fault; the retry budget
    spent gives "failed"; the int8 fallback (forced, and by the clip
    watchdog) completes with the oracle's tokens; the ledger balanced and
    no quarantined block recycled through churn (the reference's
    preempt="off" cases); the pool's quarantine, doom and in-place scrub.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.core import get_softmax as jax_get_softmax
from repro.kernels.gn_paged_attention import ops as jax_attn_ops
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import static_reference as jax_static_reference
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.gn_softmax import delta_index, gn_softmax
from repro_torch.core.luts import TPU_SOFTMAX_LUT
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import make_model
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.scheduler import FINISH_REASONS, Completion, Request

ARCH = "internlm2-1.8b"
CHUNK = 4
METRIC_KEYS = ("sentinel_checks", "sentinel_violations", "quarantined_blocks", "retries",
               "fallbacks", "table_repairs", "failed_completions", "preempt_resumes")


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None


def _requests(cls, vocab, lens=(5, 9, 7), max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(tokens=rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=max_new)
            for n in lens]


def _drive(eng, inj, kind, reqs, n_faults=2):
    """Submit, then step to the drain, injecting ``kind`` after each tick
    until ``n_faults`` took: the reference test's loop."""
    for r in reqs:
        eng.submit(r)
    records = []
    while eng.step():
        if len(records) < n_faults:
            rec = inj.inject(kind)
            if rec is not None:
                records.append(rec)
    return records


def _record(r):
    return (r.kind, r.step, r.slot, r.block, r.layer, r.leaf, r.value, r.detectable)


@pytest.fixture(scope="module")
def dense():
    """The JAX model, its params, the static oracle's tokens of the
    workload, and each fault case's JAX run on the streamed read (records,
    event log, counters, quarantined set, tokens); the port's model and
    weights."""
    jcfg = jax_reduce_config(jax_get_config(ARCH), dtype="float32")
    jmodel = jax_make_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    oracle = {}
    for key, lens in (("oracle", (5, 9, 7)), ("oracle6", (6,))):
        refs = [JaxRequest(tokens=r.tokens, max_new_tokens=6, id=i)
                for i, r in enumerate(_requests(JaxRequest, jcfg.vocab, lens))]
        rows = jax_static_reference(jmodel, jparams, refs, JaxServeConfig(max_new_tokens=6))
        oracle[key] = {r.id: rows[r.id][len(r.tokens):].tolist() for r in refs}
    runs = {}
    for kind in ("nan_tile", "inf_tile"):  # K tiles only, the JAX engine on its default read
        eng = JaxEngine(jmodel, jparams, num_slots=2, max_seq=64,
                        cfg=JaxServeConfig(max_new_tokens=6), chunk=CHUNK)
        records = _drive(eng, _JaxKTiles(eng, seed=1), kind, _requests(JaxRequest, jcfg.vocab))
        runs["k", kind] = {"records": [_record(r) for r in records],
                           "event_log": [tuple(e) for e in eng.event_log],
                           "metrics": {k: eng.metrics()[k] for k in METRIC_KEYS},
                           "tokens": {c.request_id: c.new_tokens.tolist()
                                      for c in eng.completions}}
    for kind, kv_dtype in FAULT_CASES:
        eng = JaxEngine(jmodel, jparams, num_slots=2, max_seq=64,
                        cfg=JaxServeConfig(max_new_tokens=6), chunk=CHUNK, kv_dtype=kv_dtype)
        assert eng.metrics()["read_path"] == "streamed" and eng.sentinels
        inj = JaxFaultInjector(eng, seed=1)
        records = _drive(eng, inj, kind, _requests(JaxRequest, jcfg.vocab))
        m = eng.metrics()
        runs[kind] = {"records": [_record(r) for r in records],
                      "event_log": [tuple(e) for e in eng.event_log],
                      "metrics": {k: m[k] for k in METRIC_KEYS},
                      "quarantined": set(eng.pool.quarantined),
                      "tokens": {c.request_id: c.new_tokens.tolist() for c in eng.completions}}
    model = make_model(reduce_config(get_config(ARCH), dtype="float32"))
    master = params_from_numpy(model, jax.tree.map(np.asarray, jparams), device="cpu")
    return {"model": model, "master": master, "runs": runs, **oracle}


FAULT_CASES = (("nan_tile", "fp"), ("inf_tile", "fp"), ("scale", "int8"), ("table", "fp"))


class _JaxKTiles(JaxFaultInjector):
    """The reference's injector narrowed to K tiles, as the port's
    ``leaves=("k",)`` narrows it: the leaf draw keeps its place in the
    seeded sequence, so one seed hits the same targets in both."""

    def _arena_items(self, want_scale):
        return [(k, v) for k, v in super()._arena_items(want_scale) if want_scale or k == "k"]


def _engine(dense, **kw):
    kw = {"num_slots": 2, "max_seq": 64, "cfg": ServeConfig(max_new_tokens=6), "chunk": CHUNK,
          "device": "cpu", **kw}
    return ContinuousEngine(dense["model"], dense["master"], **kw)


def _tokens(eng):
    return {c.request_id: c.new_tokens.tolist() for c in eng.completions}


def _assert_ledger(pool):
    pool.check_ledger()
    held = {b for chain in pool._slot_blocks.values() for b in chain}
    free = set(pool._free_blocks)
    assert not pool.quarantined & held and not pool.quarantined & free
    assert len(free) + len(held) + len(pool.quarantined) == pool.num_blocks


# ------------------------------------------------------------ gn_softmax --
def test_xla_cast_sends_nan_to_zero_and_saturates():
    """The index the repair gives a NaN or infinite Δ: XLA's f32 -> int32
    cast on the CPU, which the reference's ``astype`` runs, then the clip."""
    x = jnp.asarray([np.nan, np.inf, -np.inf, 3e9, -3e9], jnp.float32)
    assert np.asarray(x.astype(jnp.int32)).tolist() == [0, 2**31 - 1, -2**31, 2**31 - 1, -2**31]
    got = delta_index(torch.tensor([np.nan, np.inf, 3e9, 1e30, 0.0]), TPU_SOFTMAX_LUT)
    m = TPU_SOFTMAX_LUT.max_delta_int
    assert got.tolist() == [0, m, m, m, 0]


def test_gn_softmax_bitwise_jax_on_nonfinite_rows():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(12, 40)).astype(np.float32) * 3
    rows[:, 30:] = -1e30  # masked columns
    rows[0, 3] = np.nan
    rows[1, 5] = np.inf
    rows[2, 7] = -np.inf
    rows[3, [1, 9]] = np.inf
    rows[4, :] = -np.inf
    rows[5, :30] = np.nan
    rows[6, [2, 4]] = [np.nan, np.inf]
    rows[7, 31] = np.nan  # a NaN among the masked columns
    rows = np.concatenate([rows, [[0.1, np.nan, 0.3, -1e30] * 10,
                                  [0.2, np.inf, 0.1, 0.0] * 10]]).astype(np.float32)
    want = np.asarray(jax_get_softmax("gn")(jnp.asarray(rows)))
    got = gn_softmax(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isfinite(got).all()
    # a NaN score: every Δ is NaN, index 0, a uniform row; +Inf scores: one-hot
    # on the infinite columns
    assert (got[-2] == got[-2, 0]).all()
    np.testing.assert_array_equal(got[-1] > 0, np.isinf(rows[-1]))


# ------------------------------------------------------------ paged read --
def _poisoned(leaf: str, value: float):
    """The reference test's chunk inputs (3 live sequences, an empty one,
    GQA, shuffled tables with stale entries), with one block of sequence 0's
    live chain poisoned and a stale entry of sequence 1 naming another
    poisoned block."""
    rng = np.random.default_rng(0)
    n, h, kv, d, nb, bs, c = 4, 4, 2, 16, 12, 4, 4
    q = rng.normal(size=(n, c, h, d)).astype(np.float32)
    k = rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    v = rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    tables = rng.integers(0, nb, size=(n, 8)).astype(np.int32)
    starts, n_valid = np.array([9, 0, 17, 0], np.int32), np.array([c, c - 1, c, 0], np.int32)
    tables[1, 5] = 11  # sequence 1 reads one block (3 tokens): a stale entry
    poison = {int(tables[0, 1]), 11}
    arena = k if leaf == "k" else v
    for b in poison:
        arena[b] = value
    # rows of sequences whose read blocks hold no poison
    lengths = starts + n_valid
    reads = [set(tables[i, :-(-int(L) // bs)].tolist()) for i, L in enumerate(lengths)]
    clean = np.array([not r & poison for r in reads])
    return (q, k, v, tables, starts, n_valid), clean


@pytest.mark.parametrize("value", [np.nan, np.inf])
@pytest.mark.parametrize("leaf", ["k", "v"])
def test_plain_paged_read_over_poisoned_tiles_as_pallas_kernel(leaf, value):
    args, clean = _poisoned(leaf, value)
    mine = attn_ops.gn_paged_attention_chunk(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jax_attn_ops.gn_paged_attention_chunk(*(jnp.asarray(a) for a in args),
                                                           interpret=True))
    fin_mine, fin_ref = np.isfinite(mine).all(axis=(2, 3)), np.isfinite(ref).all(axis=(2, 3))
    np.testing.assert_array_equal(fin_mine, fin_ref)
    if leaf == "k":  # laundered: finite everywhere in both
        assert fin_mine.all()
    else:  # sequence 0 reads the poisoned V; sequence 1's stale entry is not read
        assert not fin_mine[0].any() and fin_mine[1:].all()
    np.testing.assert_allclose(mine[clean], ref[clean], atol=2e-4, rtol=0)
    assert clean.tolist() == [False, True, True, True]
    # the per-row flag: a nonfinite live score, on the rows that read a
    # poisoned K tile; a stale entry is never read, a V tile not a score
    out, flags = attn_ops.gn_paged_attention_chunk(*(torch.from_numpy(a) for a in args),
                                                   nonfinite=True)
    np.testing.assert_array_equal(out.numpy(), mine)
    assert flags.dtype == torch.int32
    lane = np.arange(4)[None, :] < args[5][:, None]
    want = lane[:, :, None] & (~clean[:, None, None] if leaf == "k" else False)
    np.testing.assert_array_equal(flags.numpy().astype(bool) & lane[:, :, None],
                                  np.broadcast_to(want, flags.shape))


# --------------------------------------------------------------- probes --
def test_probes_on_a_clean_tick_and_logits_unchanged(dense):
    """One fused tick with the probes on: the logits bit for bit those of
    the tick without them; every live slot's Σp residual within the f32
    bound (streamed and gathered reads) or 0 (the kernel's reduced probe),
    its σ residual within 1e-3; parked lanes all 0."""
    model, params = dense["model"], dense["model"].prepare(dense["master"], "cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 256, size=(3, CHUNK)).astype(np.int32))
    pos, nv = torch.tensor([0, 9, 0], dtype=torch.int32), torch.tensor([4, 1, 0], dtype=torch.int32)
    tables = torch.from_numpy(rng.permutation(16)[:12].reshape(3, 4).astype(np.int32))
    for path in ("kernel", "streamed", "gathered"):
        t_attn.FORCE_PAGED_READ = None if path == "kernel" else path
        got = []
        for sentinel in (False, True):
            cache = model.init_paged_cache(16, 4, "cpu")
            for leaf in cache.values():
                leaf.copy_(torch.from_numpy(np.random.default_rng(2).normal(
                    size=tuple(leaf.shape)).astype(np.float32)))
            got.append(model.fused_step_slots_paged(params, cache, toks, pos, nv, tables,
                                                    sentinel=sentinel))
        logits, health = got[1]
        assert torch.equal(logits, got[0])
        layers, head = health["layers"], health["head"]
        assert tuple(layers.shape) == (2, 3, 3) and tuple(head.shape) == (3,)
        bound = t_engine.SENTINEL_SUM_SLACK * 14 * torch.finfo(torch.float32).eps
        assert bool((layers[:, :2, 0] <= bound).all()) and bool((layers[:, :, 1:] == 0).all())
        if path == "kernel":
            assert bool((layers[:, :, 0] == 0).all())
        assert bool((head[:2] <= t_engine.SENTINEL_SIGMA_BOUND).all())
        assert bool((layers[:, 2] == 0).all()) and float(head[2]) == 0.0


# ------------------------------------------------- faults, streamed read --
@pytest.mark.parametrize("kind,kv_dtype", FAULT_CASES)
def test_streamed_faults_match_jax_engine(dense, kind, kv_dtype):
    """The injector's seed 1 over the workload, the reference's loop (two
    faults, injected after ticks): the port's records, event log, counters
    and quarantined set equal the JAX engine's, and its tokens the JAX
    static oracle's and the JAX engine's."""
    t_attn.FORCE_PAGED_READ = "streamed"
    eng = _engine(dense, kv_dtype=kv_dtype)
    records = _drive(eng, FaultInjector(eng, seed=1), kind,
                     _requests(Request, eng.model.cfg.vocab))
    want = dense["runs"][kind]
    m = eng.metrics()
    assert [_record(r) for r in records] == want["records"]
    assert eng.event_log == want["event_log"]
    assert {k: m[k] for k in METRIC_KEYS} == want["metrics"]
    assert eng.pool.quarantined == want["quarantined"]
    assert _tokens(eng) == dense["oracle"] == want["tokens"]
    flag = "fault_table_repair" if kind == "table" else "fault"
    flagged = [e[1] for e in eng.event_log if e[0] == flag]
    assert all(any(0 <= s - r.step <= 1 for s in flagged) for r in records)
    if kind == "table":
        assert m["table_repairs"] == len(records) and m["quarantined_blocks"] == 0
    else:
        assert m["retries"] >= 1 and any(r.block in eng.pool.quarantined for r in records)
    _assert_ledger(eng.pool)


# --------------------------------------------------- faults, kernel read --
@pytest.mark.parametrize("kind", ["nan_tile", "inf_tile"])
def test_kernel_read_flags_v_tiles_within_a_tick(dense, kind):
    eng = _engine(dense)
    assert eng.read_path == "kernel"
    records = _drive(eng, FaultInjector(eng, seed=1, leaves=("v",)), kind,
                     _requests(Request, eng.model.cfg.vocab))
    assert records and all(r.leaf == "v" for r in records)
    flagged = [e[1] for e in eng.event_log if e[0] == "fault"]
    assert all(any(0 <= s - r.step <= 1 for s in flagged) for r in records)
    assert any(r.block in eng.pool.quarantined for r in records)
    assert _tokens(eng) == dense["oracle"]
    _assert_ledger(eng.pool)


@pytest.mark.parametrize("kind", ["nan_tile", "inf_tile"])
def test_kernel_read_misses_k_tiles(dense, kind):
    """K tiles on the kernel read, no longer missed: a NaN or Inf K tile
    makes the scores nonfinite, the GN exponential launders them into a
    valid distribution and the output stays finite, so the read's per-row
    flag of a nonfinite live score carries the fault to the probe.  The
    same records, event log (every flag at the JAX engine's tick), counters
    and quarantined blocks as the JAX engine on its default (streamed)
    read, and the fault-free tokens."""
    eng = _engine(dense)
    assert eng.read_path == "kernel"
    records = _drive(eng, FaultInjector(eng, seed=1, leaves=("k",)), kind,
                     _requests(Request, eng.model.cfg.vocab))
    want = dense["runs"]["k", kind]
    assert records and all(r.leaf == "k" for r in records)
    assert [_record(r) for r in records] == want["records"]
    assert eng.event_log == want["event_log"]
    m = eng.metrics()
    assert {k: m[k] for k in METRIC_KEYS} == want["metrics"]
    assert m["sentinel_violations"] >= len(records) and m["retries"] >= 1
    assert any(r.block in eng.pool.quarantined for r in records)
    assert _tokens(eng) == dense["oracle"] == want["tokens"]
    _assert_ledger(eng.pool)


def test_bit_flip_below_detection_floor(dense):
    eng = _engine(dense)
    records = _drive(eng, FaultInjector(eng, seed=2), "bit_flip",
                     _requests(Request, eng.model.cfg.vocab))
    assert records and not any(r.detectable for r in records)
    m = eng.metrics()
    assert m["sentinel_violations"] == m["quarantined_blocks"] == 0
    assert len(eng.completions) == 3


def test_clean_run_silent(dense):
    eng = _engine(dense)
    assert eng.sentinels and eng.metrics()["sentinels"]
    eng.run(_requests(Request, eng.model.cfg.vocab))
    m = eng.metrics()
    assert m["sentinel_checks"] > 0
    assert all(m[k] == 0 for k in METRIC_KEYS if k != "sentinel_checks")
    assert _tokens(eng) == dense["oracle"]
    assert [e[0] for e in eng.event_log].count("admit") == 3
    # the kernel read's probe is finiteness (its residual 0); the σ residual
    # of the GN norm sits far under its bound
    assert m["sentinel_peak_sum_residual"] == 0.0
    assert 0.0 < m["sentinel_peak_sigma_residual"] < t_engine.SENTINEL_SIGMA_BOUND / 10


def test_sentinels_off_miss_a_fault(dense):
    t_attn.FORCE_PAGED_READ = "streamed"
    eng = _engine(dense, sentinels=False)
    assert _drive(eng, FaultInjector(eng, seed=1), "nan_tile",
                  _requests(Request, eng.model.cfg.vocab))
    m = eng.metrics()
    assert m["sentinel_checks"] == m["sentinel_violations"] == m["quarantined_blocks"] == 0
    assert _tokens(eng) != dense["oracle"]


def test_retry_budget_exhaustion_fails_closed(dense):
    t_attn.FORCE_PAGED_READ = "streamed"
    eng = _engine(dense, num_slots=1, fault_retry_budget=1)
    inj = FaultInjector(eng, seed=3)
    eng.submit(_requests(Request, eng.model.cfg.vocab, lens=(6,))[0])
    budget = 200
    while eng.step():
        inj.inject("nan_tile")  # every tick: recovery cannot win
        budget -= 1
        assert budget > 0
    assert [c.finish_reason for c in eng.completions] == ["failed"]
    m = eng.metrics()
    assert m["failed_completions"] == 1 and m["retries"] == 1
    assert any(e[0] == "fault" for e in eng.event_log)
    _assert_ledger(eng.pool)


def test_int8_fallback_completes_with_oracle_tokens(dense):
    eng = _engine(dense, num_slots=1, kv_dtype="int8")
    req = _requests(Request, eng.model.cfg.vocab, lens=(6,))[0]
    eng.submit(req)
    while eng.step():
        st = eng._slots[0]
        if st is not None and len(st.generated) >= 2:
            eng._int8_fallback(0)
    assert eng.metrics()["fallbacks"] == 1
    assert any(e[0] == "kv_fallback" for e in eng.event_log)
    (c,) = eng.completions
    assert c.finish_reason == "length" and c.new_tokens.tolist() == dense["oracle6"][0]


def test_clip_watchdog_falls_back_after_its_patience(dense):
    """A clip share above ``clip_fallback_frac`` on ``clip_patience`` clean
    ticks in a row moves the slot to the fp static path (the bound set below
    the clean share of 0 to trip it)."""
    eng = _engine(dense, num_slots=1, kv_dtype="int8", clip_fallback_frac=-1.0, clip_patience=2)
    eng.run(_requests(Request, eng.model.cfg.vocab, lens=(6,)))
    assert [e[:2] for e in eng.event_log if e[0] == "kv_fallback"] == [("kv_fallback", 1)]
    assert eng.metrics()["fallbacks"] == 1
    assert eng.completions[0].new_tokens.tolist() == dense["oracle6"][0]


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("kind", ["nan_tile", "inf_tile"])
def test_quarantine_never_leaks_under_churn(dense, seed, kind):
    """The reference's property over (seed, kind) with preempt="off" (the
    port has no preemption): across admit / finish / fault churn no
    quarantined block re-enters a chain or the free list, and the ledger
    balances after every step."""
    t_attn.FORCE_PAGED_READ = "streamed"
    eng = _engine(dense, cfg=ServeConfig(max_new_tokens=4))
    inj = FaultInjector(eng, seed=seed)
    for r in _requests(Request, eng.model.cfg.vocab, lens=(5, 9, 7, 6, 8), max_new=4, seed=seed):
        eng.submit(r)
    injected, ever = 0, set()
    while eng.step():
        if injected < 3 and inj.inject(kind):
            injected += 1
        ever |= eng.pool.quarantined
        _assert_ledger(eng.pool)
        assert eng.step_count < 400
    assert injected and ever == eng.pool.quarantined
    assert len(eng.completions) == 5


def test_ledger_reconciles_through_recycle_churn(dense):
    t_attn.FORCE_PAGED_READ = "streamed"
    eng = _engine(dense, cfg=ServeConfig(max_new_tokens=3))
    inj = FaultInjector(eng, seed=5)
    for r in _requests(Request, eng.model.cfg.vocab, lens=(5, 9, 7, 6, 8, 5, 9, 7), max_new=3):
        eng.submit(r)
    injected = 0
    while eng.step():
        if injected < 2 and eng.step_count % 3 == 0 and inj.inject("nan_tile"):
            injected += 1
        _assert_ledger(eng.pool)
    assert injected and len(eng.completions) == 8
    assert eng.pool.blocks_in_use == 0  # drained: only free and quarantined
    _assert_ledger(eng.pool)


# -------------------------------------------------------- pool, injector --
def test_pool_quarantine_doom_and_scrub_in_place(dense):
    pool = BlockPagedKVPool(dense["model"], 2, 16, 4, 6, "cpu", "int8")
    for leaf in pool.cache.values():
        leaf.fill_(3)
    ptrs = {k: v.data_ptr() for k, v in pool.cache.items()}
    slot = pool.allocate(reserve_tokens=8)
    pool.ensure(slot, 8)
    held = pool.chain_of(slot)
    assert held == [0, 1]
    pool.quarantine_block(4)  # free: leaves the free list now
    pool.quarantine_block(1)  # held: doomed until its slot is freed
    assert pool.quarantined == {4} and pool.blocks_in_use == 2
    pool.scrub_blocks({1, 4})
    for key, leaf in pool.cache.items():
        assert leaf.data_ptr() == ptrs[key]
        assert bool((leaf[:, [1, 4]] == 0).all()) and bool((leaf[:, [0, 2, 3, 5]] == 3).all())
    pool.free(slot)
    assert pool.quarantined == {1, 4} and list(pool._free_blocks) == [2, 3, 5, 0]
    assert pool.blocks_in_use == 0 and not pool.can_reserve(4 * 5)
    pool._free_blocks.append(2)
    with pytest.raises(RuntimeError, match="ledger"):
        pool.check_ledger()
    pool.reset()
    assert not pool.quarantined and pool.num_free == 2


def test_injector_refusals_and_device_loss(dense):
    eng = _engine(dense, kv_dtype="int8", cfg=ServeConfig(max_new_tokens=4))
    inj = FaultInjector(eng, seed=0)
    eng.submit(_requests(Request, eng.model.cfg.vocab, lens=(5,), max_new=4)[0])
    assert inj.inject("nan_tile") is None  # no committed KV yet
    eng.step()
    with pytest.raises(ValueError, match="nonfinite"):
        inj.inject("nan_tile")
    assert inj.inject("device_loss") is None
    with pytest.raises(ValueError, match="unknown"):
        FaultInjector(eng, kinds=("cosmic_ray",))


def test_finish_reason_closed_set():
    assert FINISH_REASONS == ("length", "stop", "failed")
    kw = dict(request_id=0, prompt_tokens=np.zeros(1, np.int32), new_tokens=np.zeros(0, np.int32),
              arrival_step=0, admit_step=0, first_token_step=0, finish_step=0, admit_time=0.0,
              first_token_time=0.0, finish_time=0.0)
    for reason in FINISH_REASONS:
        Completion(finish_reason=reason, **kw)
    with pytest.raises(ValueError, match="finish_reason"):
        Completion(finish_reason="rejected", **kw)
