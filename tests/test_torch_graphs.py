"""The compile-once tick of the port: its trace keys against the reference's
``repro.analysis.tracekeys``, the static decode step with its position as
a device tensor, the engine's device state kept in place across ticks and
resets (what a CUDA graph needs), the launch counters' snapshot and add,
and, on the card (marked ``cuda``, skipped without one), the graphed ticks
and the graphed static decode step against their eager runs, bit for bit.

On the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_graphs.py tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from _serve_helpers import assert_exact_compile_counters
from repro.analysis import tracekeys as jax_tracekeys
from repro_torch.analysis import tracekeys
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.kernels import counters
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.workload import required_max_seq, seeded_requests

ARCH = "internlm2-1.8b"


# ------------------------------------------------------------ trace keys --
@pytest.mark.parametrize("max_seq,block_size", [
    (1, 1), (16, 16), (17, 16), (26, 4), (26, 8), (64, 4), (1000, 7), (1056, 16),
    (4096, 16), (5, 64), (0, 16), (16, 0)])
def test_tracekeys_equal_the_reference(max_seq, block_size):
    """Grid, key space, bound, seen keys and the diff text equal the
    reference's for a spread of pools, refusals included."""
    if max_seq <= 0 or block_size <= 0:
        for mod in (tracekeys, jax_tracekeys):
            with pytest.raises(ValueError):
                mod.horizon_bucket_grid(max_seq, block_size)
        return
    grid = tracekeys.horizon_bucket_grid(max_seq, block_size)
    assert grid == jax_tracekeys.horizon_bucket_grid(max_seq, block_size)
    assert grid[-1] == -(-max_seq // block_size)
    for kw in ({"paged": True, "max_seq": max_seq, "block_size": block_size},
               {"paged": True, "grid": grid}, {"paged": False}):
        assert tracekeys.trace_key_space(**kw) == jax_tracekeys.trace_key_space(**kw)
        assert tracekeys.compile_bound(**kw) == jax_tracekeys.compile_bound(**kw)
    metrics = [{"horizon_bucket_grid": grid, "fused_buckets": grid[:2],
                "decode_buckets": grid[-1:]},
               {"fused_step_compilations": 1, "decode_compilations": 0}]
    for m in metrics:
        seen = tracekeys.seen_trace_keys(m)
        assert seen == jax_tracekeys.seen_trace_keys(m)
        expected = tracekeys.trace_key_space(paged=True, grid=grid[:1])
        counts = {"fused": 2, "decode": 1}
        assert (tracekeys.format_trace_key_diff(expected, seen, counts)
                == jax_tracekeys.format_trace_key_diff(expected, seen, counts))


# ------------------------------------------------------- static decode step --
def _static(dtype, device):
    cfg = reduce_config(get_config(ARCH), dtype=dtype)
    model = make_model(cfg)
    params = model.prepare(model.init(0, "cpu"), device)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, size=(3, 9)),
                             dtype=torch.int32, device=device)
    return model, params, tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_with_tensor_pos_is_the_int_pos_step(dtype):
    """Four decode steps with the position as a 0-d int32 tensor give the
    logits and the slab cache of the Python-int steps, bit for bit."""
    model, params, tokens = _static(dtype, "cpu")
    s, steps = tokens.shape[1], 4
    runs = []
    for as_tensor in (False, True):
        logits, cache = model.prefill(params, {"tokens": tokens}, s + steps)
        outs = [logits]
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(steps):
            pos = torch.tensor(s + i, dtype=torch.int32) if as_tensor else s + i
            step, cache = model.decode_step(params, cache, nxt, pos)
            outs.append(step)
            nxt = step[:, 0].argmax(-1).to(torch.int32)[:, None]
        runs.append((outs, cache))
    (want, want_cache), (got, got_cache) = runs
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(got_cache[k], want_cache[k]) for k in ("k", "v"))


def test_prefill_into_a_given_cache_equals_a_fresh_one():
    """``prefill(cache=...)`` zeroes a used slab and writes it in place: the
    logits and slabs of a fresh prefill, the same tensors; other shapes are
    refused."""
    model, params, tokens = _static("float32", "cpu")
    s = tokens.shape[1]
    want, fresh = model.prefill(params, {"tokens": tokens}, s + 3)
    used = {k: torch.randn(v.shape) for k, v in fresh.items()}
    ptrs = {k: v.data_ptr() for k, v in used.items()}
    got, cache = model.prefill(params, {"tokens": tokens}, s + 3, cache=used)
    assert cache is used and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert torch.equal(got, want)
    assert all(torch.equal(cache[k], fresh[k]) for k in ("k", "v"))
    with pytest.raises(ValueError, match="init_cache"):
        model.prefill(params, {"tokens": tokens}, s + 4, cache=used)


# ------------------------------------------------------------- engine state --
def test_engine_device_state_stays_in_place_across_ticks_and_reset():
    """Every tensor the tick reads or writes is allocated once: a captured
    graph replays against the same addresses after any tick or reset."""
    cfg = reduce_config(get_config(ARCH), dtype="float32")
    model = make_model(cfg)
    reqs = seeded_requests(cfg.vocab, 4, 3, 20, 3, seed=4)
    eng = ContinuousEngine(model, model.init(0, "cpu"), num_slots=2,
                           max_seq=required_max_seq(reqs), chunk=4, block_size=4, device="cpu")

    sh = eng.shards[0]

    def state():
        tensors = [sh._last_logits, sh._pos_dev, sh._active_dev, sh._parked,
                   *[t for kind in sorted(sh._inputs) for t in sh._inputs[kind]],
                   *[sh._tables_dev[b] for b in eng.horizon_bucket_grid],
                   *eng.pool.caches[0].values()]
        return [t.data_ptr() for t in tensors]

    before = state()
    first = {c.request_id: c.new_tokens.tolist() for c in eng.run(reqs)}
    assert state() == before
    m = eng.metrics()
    assert len(m["horizon_buckets"]) >= 2 and m["fused_buckets"] and m["decode_buckets"]
    assert m["horizon_bucket_grid"] == tracekeys.horizon_bucket_grid(eng.max_seq, 4)
    eng.reset()
    assert state() == before and not sh._active_dev.any() and not sh._pos_dev.any()
    assert eng.metrics()["horizon_buckets"] == []
    assert {c.request_id: c.new_tokens.tolist() for c in eng.run(reqs)} == first
    assert eng.metrics()["horizon_buckets"] == m["horizon_buckets"]


def test_counters_snapshot_and_add_round_trip():
    counters.reset()
    zero = counters.snapshot()
    assert set(zero) == {0} and len(zero) == len(counters.WRAPPERS) + len(counters.PLAIN)
    delta = list(range(1, len(zero) + 1))
    counters.add(delta)
    assert list(counters.snapshot()) == delta
    assert list(counters.launch_counts().values()) == delta[:len(counters.WRAPPERS)]
    assert list(counters.plain_cuda_calls().values()) == delta[len(counters.WRAPPERS):]
    counters.add([-d for d in delta])
    assert counters.snapshot() == zero
    with pytest.raises(ValueError):
        counters.add(delta[:-1])


def test_step_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        StepGraphs(torch.device("cpu"))


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` here: records its replays."""
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


def test_step_graphs_capture_once_and_count_launches_per_replay(monkeypatch):
    """The runner's bookkeeping, with the CUDA primitives faked (this box
    has no card): one warm-up and one capture per key, then a replay on
    every call, captures counted per step kind, and the launch counters
    moved by what the capture counted on each replay, never by the warm-up
    or the capture itself; Python's garbage collector paused for each
    capture only."""
    import contextlib
    import gc

    from repro_torch.kernels.gn_layernorm import ops as norm_ops
    from repro_torch.kernels.gn_paged_attention import ops as paged_ops

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    calls = {"fn": 0, "warmup": 0}
    collecting = []  # the garbage collector's state at each call
    out = torch.zeros(3)

    def tick(name, norms):
        def fn():
            calls[name] += 1
            collecting.append((name, gc.isenabled()))
            norm_ops.launches += norms
            paged_ops.launches += 1
            return out
        return fn

    counters.reset()
    _FakeGraph.replays = 0
    graphs = StepGraphs(torch.device("cuda"))
    for _ in range(3):
        assert graphs.run(("fused", 4), tick("fn", 5), tick("warmup", 5)) is out
    assert graphs.run(("decode", 4), tick("fn", 2), tick("warmup", 2)) is out
    assert calls == {"fn": 2, "warmup": 2} and _FakeGraph.replays == 4
    # no collection inside a capture (it could free a dead graph mid-capture)
    assert collecting == [("warmup", True), ("fn", False)] * 2 and gc.isenabled()
    assert graphs.captures == {"fused": 1, "decode": 1}
    launches = counters.launch_counts()
    assert (launches["gn_rmsnorm"], launches["gn_paged_attention"]) == (3 * 5 + 2, 4)
    counters.reset()


# ------------------------------------------------------------------ on card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _engine_run(device, dtype, kv_dtype, eager=False):
    """The reduced config's engine on ``device`` over seeded requests (chunk
    4, block 4, 2 slots), weights from one CPU seed; ``eager``: the tick
    function called directly, without graphs."""
    cfg = reduce_config(get_config(ARCH), dtype=dtype)
    model = make_model(cfg)
    reqs = seeded_requests(cfg.vocab, 6, 4, 40, 8, seed=2)
    eng = ContinuousEngine(model, model.init(0, "cpu"), num_slots=2,
                           max_seq=required_max_seq(reqs), chunk=4, block_size=4, device=device,
                           kv_dtype=kv_dtype)
    if eager:
        eng.shards[0]._graphs = None
    toks = {c.request_id: c.tokens for c in eng.run(reqs)}
    return eng, reqs, toks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_graphed_engine_equals_the_eager_tick_on_card(cuda, kv_dtype, dtype):
    """Every tick a graph replay, one capture per (kind, bucket) seen within
    the reference's bound (its own ``assert_exact_compile_counters``); the
    greedy tokens, the held logits and the real blocks of the arenas (and
    int8 scales) bit for bit the eager tick's on the card; a reset and a
    rerun replay the same tokens without a new capture."""
    eng, reqs, toks = _engine_run(cuda, dtype, kv_dtype)
    m = eng.metrics()
    assert_exact_compile_counters(m)
    assert m["transfer_guarded_ticks"] == m["model_ticks"] > 0
    assert len(m["horizon_buckets"]) >= 3  # the workload crosses buckets
    eager, _, eager_toks = _engine_run(cuda, dtype, kv_dtype, eager=True)
    assert eager.metrics()["horizon_buckets"] == m["horizon_buckets"]
    for rid, t in eager_toks.items():
        assert np.array_equal(toks[rid], t), rid
    assert torch.equal(eng.shards[0]._last_logits, eager.shards[0]._last_logits)
    nb = eng.pool.num_blocks  # the write sink past them is never read
    for key, arena in eng.pool.caches[0].items():
        assert torch.equal(arena[:, :nb], eager.pool.caches[0][key][:, :nb]), key
    captures = (m["fused_step_compilations"], m["decode_compilations"])
    eng.reset()
    again = {c.request_id: c.tokens for c in eng.run(reqs)}
    assert all(np.array_equal(again[rid], toks[rid]) for rid in toks)
    m2 = eng.metrics()
    assert (m2["fused_step_compilations"], m2["decode_compilations"]) == captures
    assert_exact_compile_counters(m2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_generate_equals_the_eager_decode_on_card(cuda, dtype):
    """``generate`` replays one decode graph per (B, max_seq): its tokens
    equal the eager prefill and int-position decode steps on the card; a
    second call replays without a capture, another batch size captures its
    own graph."""
    model, params, tokens = _static(dtype, cuda)
    new = 6
    got = generate(model, params, {"tokens": tokens}, ServeConfig(max_new_tokens=new))
    s = tokens.shape[1]
    logits, cache = model.prefill(params, {"tokens": tokens}, s + new)
    want, last = [tokens], logits[:, -1]
    for i in range(new):
        nxt = last.argmax(-1).to(torch.int32)[:, None]
        want.append(nxt)
        step, cache = model.decode_step(params, cache, nxt, s + i)
        last = step[:, 0]
    assert torch.equal(got, torch.cat(want, 1))
    decoders = model._static_decoders
    assert list(decoders) == [(3, s + new)]
    assert decoders[3, s + new].graphs.captures == {"decode": 1}
    assert torch.equal(generate(model, params, {"tokens": tokens}, ServeConfig(max_new_tokens=new)),
                       got)
    generate(model, params, {"tokens": tokens[:2]}, ServeConfig(max_new_tokens=new))
    assert {k: d.graphs.captures["decode"] for k, d in decoders.items()} == {
        (3, s + new): 1, (2, s + new): 1}
