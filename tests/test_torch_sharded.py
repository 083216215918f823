"""The port's sharded continuous serving (``ContinuousEngine(devices=N)``) on
the CPU, as N shards of ``device="cpu"``: the counterpart of the reference's
forced host devices (``tests/test_serve_sharded.py``).

  * the pools' host accounting against the JAX pools built in this process
    with ``mesh=None, num_devices=2``, operation for operation: slot ranges
    and least-loaded picks, indivisible slots refused, per-device block
    ranges, FIFO lists and reservations, the arena rounded to a device
    multiple, the no-device allocate checking the popped slot's device, the
    global FIFO at one device, and ``mark_device_lost``;
  * the engine at ``devices=2`` against ``devices=1`` and the JAX engine at
    ``devices=1``, reduced f32 models: dense and MLA over the paged and the
    slab pool, int8 arenas and the prefix cache on dense paged, xlstm and
    zamba2 on the slab, whisper paged and the VLM on the slab; tokens,
    completions and event logs equal (admissions compared without their
    slot and device, which placement changes), the held logits of every
    live request within 1e-6 after every tick;
  * behaviour: least-loaded placement, a prefix hit pulling a request to
    the device that holds its blocks, device loss (the reference's
    ``test_device_loss_detected_and_survivors_complete``), a snapshot round
    trip at two shards and a topology mismatch, ``--devices`` in both
    forms (never the CPU unless asked), the MoE refusal,
    ``make_slot_mesh``, and the launch helper and the graph runner entering
    the shard's device (the CUDA calls faked), with every ctypes entry of
    the four kernel wrappers called through the helper.

The JAX engine at ``devices=2`` runs in a subprocess of its own
(``tests/test_torch_sharded_jax.py``).
"""
import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.kv_cache import BlockPagedKVPool as JaxPool
from repro.serve.kv_cache import SlotKVPool as JaxSlotPool
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.parallel.sharding import make_slot_mesh
from repro_torch.serve import graphs as graphs_mod
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, static_reference
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.kv_cache import BlockPagedKVPool, SlotKVPool

from _torch_parity import CHUNK, COMPLETION_KEYS, OWN, jax_engine, pair, prompt, to_port

ROOT = Path(__file__).resolve().parents[1]
DENSE, MLA = "internlm2-1.8b", "minicpm3-4b"
LENS = (5, 9, 14, 22, 7)  # the reference's mixed requests
TOL = 1e-6


def _mixed(vocab, max_new=4):
    return [JaxRequest(id=i, tokens=prompt(vocab, n, 500 + i), max_new_tokens=max_new,
                       arrival_step=i) for i, n in enumerate(LENS)]


def _shared_prefix(vocab):
    """Five requests over one 12-token system prompt, two of them also over
    one 8-token persona: the first two (one of each) fill a slot of each
    device at step 0, and the later ones hit the prompts they indexed, on a
    device that has room for them (so that one device and two admit them
    at the same ticks)."""
    system, persona = prompt(vocab, 12, 600), prompt(vocab, 8, 601)
    tails = [(prompt(vocab, n, 610 + i), p) for i, (n, p) in
             enumerate(((3, False), (2, True), (4, False), (3, True), (5, False)))]
    return [JaxRequest(id=i, tokens=np.concatenate([system, *([persona] if p else []), t]),
                       max_new_tokens=4, arrival_step=(0, 0, 10, 10, 11)[i])
            for i, (t, p) in enumerate(tails)]


def _modality(cfg, seed) -> dict:
    """A request's random frames (encdec) or patches (VLM); nothing else."""
    rng = np.random.default_rng(seed)
    shape = {"encdec": ("frames", (cfg.encoder_seq, cfg.d_model)),
             "vlm": ("patches", (cfg.num_patches, cfg.d_model))}.get(cfg.family)
    return {} if shape is None else {shape[0]: rng.normal(size=shape[1]).astype(np.float32)}


# ------------------------------------------------------- pools, both sides --
def _pool_state(pool):
    """A pool's host ledger, either package's."""
    return {"free_slots": list(pool._free_slots if hasattr(pool, "_free_slots")
                               else pool._free),
            "free_blocks": [list(q) for q in getattr(pool, "_free_blocks", [])],
            "tables": np.asarray(getattr(pool, "tables", np.zeros(0))).tolist(),
            "reserved": np.asarray(getattr(pool, "_reserved", np.zeros(0))).tolist(),
            "quarantined": sorted(getattr(pool, "quarantined", ())),
            "lost": sorted(getattr(pool, "_lost_devices", ()))}


@pytest.fixture(scope="module")
def dense():
    return pair(DENSE)


def _slot_pools(dense, num_devices=1, **kw):
    jmodel, _, model, _ = dense
    return (JaxSlotPool(jmodel, mesh=None, num_devices=num_devices, **kw),
            SlotKVPool(model, device=["cpu"] * num_devices, **kw))


def _paged_pools(dense, num_devices=1, **kw):
    jmodel, _, model, _ = dense
    return (JaxPool(jmodel, mesh=None, num_devices=num_devices, **kw),
            BlockPagedKVPool(model, device=["cpu"] * num_devices, **kw))


def test_slot_pool_ranges_and_least_loaded_pick_as_jax(dense):
    states = []
    for pool in _slot_pools(dense, num_slots=4, max_seq=16, num_devices=2):
        got = [pool.per_device_slots, [pool.device_of(s) for s in range(4)], pool.pick_device(),
               pool.allocate(device=0), pool.pick_device(), pool.allocate(device=1),
               pool.pick_device()]
        pool.free(0)
        got += [pool.free_slots_on(0), pool.free_slots_on(1), pool.pick_device()]
        states.append(got)
    assert states[0] == states[1] == [2, [0, 0, 1, 1], 0, 0, 1, 2, 0, 2, 1, 0]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_indivisible_slots_refused_as_jax(dense, paged):
    jmodel, _, model, _ = dense
    kw = dict(num_slots=3, max_seq=16, **({"block_size": 4} if paged else {}))
    jax_cls, cls = (JaxPool, BlockPagedKVPool) if paged else (JaxSlotPool, SlotKVPool)
    with pytest.raises(ValueError, match="divide evenly"):
        jax_cls(jmodel, mesh=None, num_devices=2, **kw)
    with pytest.raises(ValueError, match="divide evenly"):
        cls(model, device=["cpu"] * 2, **kw)


def test_paged_pool_per_device_blocks_and_reservations_as_jax(dense):
    """The reference's script (``test_paged_pool_per_device_blocks_and_
    reservations``) on both pools: every answer and the ledger after every
    operation equal."""
    seen = []
    for pool in _paged_pools(
            dense, num_slots=4, max_seq=16, block_size=4, num_blocks=8, num_devices=2):
        log = [pool.blocks_per_device, pool.max_request_blocks]
        s0 = pool.allocate(reserve_tokens=16, device=0)
        log += [s0, pool.device_of(s0), pool.can_reserve(4, device=0),
                pool.can_reserve(16, device=1), pool.pick_device(4)]
        s1 = pool.allocate(reserve_tokens=8, device=1)
        pool.ensure(s0, 6)
        pool.ensure(s1, 6)
        log += [list(pool.tables[s0, :2]), list(pool.tables[s1, :2]),
                pool.blocks_in_use_on(0), pool.blocks_in_use_on(1), pool.reserved_on(0),
                pool.reserved_on(1), pool.unfilled_on(0), pool.unfilled_on(1),
                _pool_state(pool)]
        pool.free(s0)
        log += [pool.free_blocks_on(0), pool.free_blocks_on(1), _pool_state(pool)]
        s2 = pool.allocate(reserve_tokens=4, device=0)
        pool.ensure(s2, 2)
        log += [int(pool.tables[s2, 0]), list(pool.peak_reserved_per_device),
                list(pool.peak_used_per_device)]
        pool.free(s1)
        pool.free(s2)
        log += [pool.blocks_in_use, pool.blocks_reserved, _pool_state(pool)]
        seen.append([np.asarray(x).tolist() if isinstance(x, np.ndarray) else x for x in log])
    assert seen[0] == seen[1]
    assert seen[1][:7] == [4, 4, 0, 0, False, True, 1]
    assert seen[1][7:9] == [[0, 1], [4, 5]]  # each slot's blocks from its own range


def test_arena_rounds_to_a_device_multiple_as_jax(dense):
    for pool in _paged_pools(dense, num_slots=2, max_seq=16, block_size=4, num_blocks=7,
                             num_devices=2):
        assert (pool.num_blocks, pool.blocks_per_device) == (8, 4)
    port = pool
    # each shard's arena holds its own range and its own write sink
    assert [c["k"].shape[1] for c in port.caches] == [5, 5]


def test_no_device_allocate_checks_the_popped_slots_device_as_jax(dense):
    seen = []
    for pool in _paged_pools(
            dense, num_slots=4, max_seq=16, block_size=4, num_blocks=8, num_devices=2):
        pool.allocate(reserve_tokens=16, device=0)
        pool.allocate(device=0)
        s = pool.allocate(reserve_tokens=8)
        log = [s, pool.device_of(s)]
        pool.allocate(reserve_tokens=4)
        pool.free(s)
        with pytest.raises(RuntimeError, match="device 1"):
            pool.allocate(reserve_tokens=16)
        log += [pool._free_slots[0], _pool_state(pool)]
        seen.append(log)
    assert seen[0] == seen[1] and seen[1][:3] == [2, 1, 2]


def test_single_device_pools_keep_the_global_fifo_as_jax(dense):
    for pool in _slot_pools(dense, num_slots=3, max_seq=16):
        assert pool.num_devices == 1 and pool.per_device_slots == 3
        assert [pool.allocate(device=pool.pick_device()) for _ in range(3)] == [0, 1, 2]
        pool.free(1)
        pool.free(0)
        assert pool.allocate(device=pool.pick_device()) == 1


def test_mark_device_lost_as_jax(dense):
    seen = []
    for pool in _paged_pools(
            dense, num_slots=4, max_seq=16, block_size=4, num_blocks=8, num_devices=2):
        s = pool.allocate(reserve_tokens=8, device=1)
        pool.ensure(s, 6)
        pool.mark_device_lost(1)
        log = [_pool_state(pool), sorted(pool._doomed), pool.pick_device(4),
               pool.can_reserve(4, device=1), pool.quarantined_on(1)]
        pool.free(s)
        log += [_pool_state(pool), pool.quarantined_on(1), pool.blocks_in_use]
        pool.check_ledger()
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[1][-3]["free_slots"] == [0, 1] and seen[1][-2] == 4


def test_local_tables_map_each_range_to_its_arena(dense):
    _, _, model, _ = dense
    pool = BlockPagedKVPool(model, num_slots=4, max_seq=16, block_size=4, num_blocks=8,
                            device=["cpu"] * 2)
    s = pool.allocate(reserve_tokens=12, device=1)
    pool.ensure(s, 9)
    assert pool.chain_of(s) == [4, 5, 6]
    assert pool.local_tables(1, 4).tolist() == [[0, 1, 2, 0], [0, 0, 0, 0]]
    assert pool.local_tables(0, 2).tolist() == [[0, 0], [0, 0]]


# ---------------------------------------------------------------- engines --
def _events(eng):
    """The event log with each admission's and resume's slot and device
    left out (placement, which sharding changes)."""
    return [tuple(e[:3]) if e[0] in ("admit", "resume") else tuple(e) for e in eng.event_log]


def _completions(comps):
    return {c.request_id: {k: getattr(c, k) for k in COMPLETION_KEYS} for c in comps}


def _lockstep(engines, reqs) -> float:
    """Run the engines tick for tick over ``reqs``; after every tick the held
    logits of each live request agree across them.  Returns the largest
    difference seen."""
    for eng in engines:
        for r in reqs:
            eng.submit(r)
    worst, going = 0.0, True
    while going:
        going = [eng.step() for eng in engines]
        assert len(set(going)) == 1, "the engines drained at different ticks"
        going = going[0]
        rows = []
        for eng in engines:
            held = eng.held_logits()
            rows.append({st.req.id: held[s] for s, st in enumerate(eng._slots) if st is not None})
        assert all(r.keys() == rows[0].keys() for r in rows)
        for rid, row in rows[0].items():
            for other in rows[1:]:
                worst = max(worst, float((other[rid] - row).abs().max()))
    return worst


# case -> (arch, engine options); paged at 8-token blocks (fewer horizon
# buckets for the JAX engine to compile), 4-token chunks
CASES = {
    "dense-paged": (DENSE, {"block_size": 8}),
    "dense-slab": (DENSE, {"paged": False, "sentinels": False}),
    "mla-paged": (MLA, {"block_size": 8}),
    "mla-slab": (MLA, {"paged": False, "sentinels": False}),
    "dense-paged-int8": (DENSE, {"block_size": 8, "kv_dtype": "int8"}),
    "dense-paged-prefix": (DENSE, {"block_size": 4, "prefix_cache": True}),
    # the families whose slots nothing couples: recurrent carries on the
    # slab pool, cross-attention memories (extras) on the paged and slab ones
    "ssm-slab": ("xlstm-350m", {}),
    "hybrid-slab": ("zamba2-7b", {}),
    "encdec-paged": ("whisper-large-v3", {"block_size": 8}),
    "vlm-slab": ("llama-3.2-vision-11b", {"paged": False, "sentinels": False}),
}
# a device indexes its own copy of a prompt it served, so with the prefix
# cache the index's occupancy is per device
PER_DEVICE_COPIES = {"prefix_cached_blocks", "prefix_inserts", "peak_blocks_in_use",
                     "block_utilization"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_shards_serve_the_one_device_and_jax_runs(case):
    arch, kw = CASES[case]
    jmodel, jparams, model, master = pair(arch)
    jreqs = (_shared_prefix if "prefix" in case else _mixed)(jmodel.cfg.vocab)
    for r in jreqs:
        r.extras = _modality(jmodel.cfg, 300 + r.id)
    reqs = to_port(jreqs)
    common = dict(num_slots=4, max_seq=max(r.prompt_len + r.max_new_tokens for r in reqs),
                  **kw)
    jeng = jax_engine(jmodel, jparams, **common)
    jcomps = jeng.run(jreqs)
    engines = [ContinuousEngine(model, master, cfg=ServeConfig(), chunk=CHUNK, device="cpu",
                                devices=d, **common) for d in (1, 2)]
    worst = _lockstep(engines, reqs)
    assert worst <= TOL, f"held logits part by {worst}"
    one, two = engines
    want = {c.request_id: np.asarray(c.new_tokens).tolist() for c in jcomps}
    for eng in engines:
        assert {c.request_id: c.new_tokens.tolist() for c in eng.completions} == want
        assert _completions(eng.completions) == _completions(jcomps)
        assert _events(eng) == _events(jeng)
    # one device is the unsharded engine, placement included
    assert [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
            for e in jeng.event_log] == one.event_log
    m1, m2, mj = one.metrics(), two.metrics(), jeng.metrics()
    assert (m2["num_devices"], m2["per_device_slots"]) == (2, 2)
    assert sum(m2["device_admits"]) == len(reqs) and 0.0 < m2["shard_balance"] <= 1.0
    shared = (set(m1) & set(mj)) - OWN
    assert {k: m1[k] for k in shared} == {k: mj[k] for k in shared}
    placed = shared - {"num_devices", "per_device_slots", "device_admits", "shard_balance"}
    if "prefix" in case:
        placed -= PER_DEVICE_COPIES
    assert {k: m2[k] for k in placed} == {k: m1[k] for k in placed}
    if two.paged:
        assert two.pool.blocks_in_use == two.pool.cached_blocks  # drained on both shards
    if "prefix" in case:
        assert m2["prefix_hit_requests"] > 0 and two.request_prefix_hits


def _dense_engine(devices=2, **kw):
    _, _, model, master = pair(DENSE)
    kw = {"num_slots": 4, "max_seq": 32, **kw}
    return ContinuousEngine(model, master, cfg=ServeConfig(), chunk=CHUNK, device="cpu",
                            devices=devices, **kw)


def test_least_loaded_admission_places_across_devices():
    """Two requests at once land on slots 0 and 2 (each device's FIFO head),
    not both on device 0 (the reference's test)."""
    eng = _dense_engine(max_seq=16)
    vocab = eng.model.cfg.vocab
    for i in range(2):
        eng.submit(to_port([JaxRequest(id=i, tokens=prompt(vocab, 8, 520 + i),
                                       max_new_tokens=8, arrival_step=0)])[0])
    eng.step()
    assert eng.device_occupancy() == [1, 1]
    assert [s for s, st in enumerate(eng._slots) if st is not None] == [0, 2]
    assert list(eng._device_admits) == [1, 1]
    assert [e[3:] for e in eng.event_log if e[0] == "admit"] == [(0, 0), (2, 1)]
    eng.run([])
    assert eng.metrics()["shard_balance"] == 1.0


def test_prefix_hit_pulls_the_request_to_its_device():
    """A finished prompt is indexed in device 0's tree; while an unrelated
    request holds a device-0 slot, least-loaded placement would put the next
    request on device 1, and its prefix hit pulls it to device 0 instead.
    Its tokens equal the run without the cache."""
    _, _, model, _ = pair(DENSE)
    vocab = model.cfg.vocab
    system = prompt(vocab, 12, 630)
    jreqs = [JaxRequest(id=0, tokens=np.concatenate([system, prompt(vocab, 3, 631)]),
                        max_new_tokens=2, arrival_step=0),
             JaxRequest(id=1, tokens=prompt(vocab, 6, 632), max_new_tokens=12,
                        arrival_step=8),
             JaxRequest(id=2, tokens=np.concatenate([system, prompt(vocab, 4, 633)]),
                        max_new_tokens=3, arrival_step=9)]
    toks = []
    for cache in (True, False):
        eng = _dense_engine(prefix_cache=cache)
        comps = eng.run(to_port(jreqs))
        toks.append({c.request_id: c.new_tokens.tolist() for c in comps})
        admits = {e[2]: e[4] for e in eng.event_log if e[0] == "admit"}
        if cache:
            assert admits == {0: 0, 1: 0, 2: 0}
            assert eng.request_prefix_hits[2]["device"] == 0
            assert eng.request_prefix_hits[2]["tokens"] >= 12
        else:
            assert admits == {0: 0, 1: 0, 2: 1}  # least-loaded, no pull
    assert toks[0] == toks[1]


def test_device_loss_detected_and_survivors_complete():
    """The reference's test: NaN over one device's whole block range makes
    every live slot there violate in one tick; the device is lost, its range
    quarantined and its slots retired, and every request still completes
    token for token as the static oracle."""
    _, _, model, _ = pair(DENSE)
    vocab = model.cfg.vocab
    reqs = to_port([JaxRequest(id=i, tokens=prompt(vocab, n, 700 + i), max_new_tokens=5,
                               arrival_step=0) for i, n in enumerate((5, 9, 7, 6, 8, 5))])
    eng = _dense_engine(max_seq=64)
    inj = FaultInjector(eng, seed=3)
    for r in reqs:
        eng.submit(r)
    lost, budget = False, 400
    while eng.step():
        if not lost and inj.inject("device_loss"):
            lost = True
        budget -= 1
        assert budget > 0
    assert lost and inj.records[-1].kind == "device_loss"
    dead = sorted(eng.pool._lost_devices)
    assert len(dead) == 1
    d = dead[0]
    assert any(e[0] == "device_lost" and e[2] == d for e in eng.event_log)
    lo = d * eng.pool.blocks_per_device
    assert set(range(lo, lo + eng.pool.blocks_per_device)) <= eng.pool.quarantined
    assert all(eng.pool.device_of(s) != d for s in eng.pool._free_slots)
    eng.pool.check_ledger()
    ref = static_reference(model, eng.params, reqs, ServeConfig())
    assert len(eng.completions) == len(reqs)
    for c in eng.completions:
        assert c.finish_reason == "length" and np.array_equal(c.tokens, ref[c.request_id])
    # one device has no device to lose
    assert FaultInjector(_dense_engine(devices=1), seed=3).inject("device_loss") is None


def test_snapshot_round_trip_at_two_shards_and_topology_mismatch(tmp_path):
    _, _, model, _ = pair(DENSE)
    reqs = to_port(_mixed(model.cfg.vocab))
    full = _dense_engine()
    want = {c.request_id: c.new_tokens.tolist() for c in full.run(reqs)}
    half = _dense_engine()
    for r in reqs:
        half.submit(r)
    for _ in range(7):
        half.step()
    half.snapshot(tmp_path)
    back = _dense_engine()
    back.restore(tmp_path)
    assert back.event_log == half.event_log and list(back._device_admits) == list(
        half._device_admits)
    while back.step():
        pass
    assert {c.request_id: c.new_tokens.tolist() for c in back.completions} == want
    assert back.event_log == full.event_log
    assert back.metrics()["device_admits"] == full.metrics()["device_admits"]
    with pytest.raises(ValueError, match="num_devices"):
        _dense_engine(devices=1).restore(tmp_path)


def test_devices_flag_parses_both_forms_and_never_falls_back_to_the_cpu():
    """``--devices N`` and ``--devices=N`` (the reference's two forms); without
    ``--device`` the shards want N cards, and a box with fewer refuses the
    run rather than serve it on the CPU."""
    parse = launch_serve.build_parser().parse_args
    assert parse(["--devices", "2"]).devices == 2 and parse(["--devices=3"]).devices == 3
    assert parse([]).devices == 1 and parse([]).device is None
    if torch.cuda.device_count() < 2:
        with pytest.raises((RuntimeError, ValueError), match="cpu"):
            launch_serve.main(["--smoke", "--continuous", "--devices", "2"])


def test_moe_refused_under_devices():
    _, _, model, master = pair("llama4-scout-17b-a16e")
    with pytest.raises(NotImplementedError, match="8b"):
        ContinuousEngine(model, master, num_slots=2, max_seq=32, chunk=CHUNK, device="cpu",
                         devices=2)


def test_make_slot_mesh():
    assert make_slot_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match=">= 1"):
        make_slot_mesh(0, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="visible"):
            make_slot_mesh(2)
    with pytest.raises(ValueError, match="divide evenly"):
        _dense_engine(num_slots=3)
    with pytest.raises(ValueError, match=">= 1"):
        _dense_engine(devices=0)


# ------------------------------------------------- the shard's device, faked --
class _FakeDevice:
    """Stands in for ``torch.cuda.device``: records the current index."""
    current = 0

    def __init__(self, device):
        self.index = torch.device(device).index

    def __enter__(self):
        self.prev, _FakeDevice.current = _FakeDevice.current, self.index

    def __exit__(self, *exc):
        _FakeDevice.current = self.prev


def test_launch_helper_and_graph_runner_enter_the_shards_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", _FakeDevice)
    _FakeDevice.current = 0
    seen = []
    assert _build.launch(torch.device("cuda", 1), lambda *a: seen.append(
        (_FakeDevice.current, a)) or 0, 7, 8) == 0
    assert seen == [(1, (7, 8))] and _FakeDevice.current == 0

    class Stream:
        def __init__(self, device=None):
            seen.append(("stream", _FakeDevice.current))

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            seen.append(("replay", _FakeDevice.current))

    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: seen.append(("pool", _FakeDevice.current)))
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    seen.clear()
    runner = graphs_mod.StepGraphs(torch.device("cuda", 1))
    for _ in range(2):
        runner.run(("fused", 1), lambda: seen.append(("fn", _FakeDevice.current)),
                   lambda: seen.append(("warmup", _FakeDevice.current)))
    assert all(dev == 1 for _, dev in seen) and _FakeDevice.current == 0
    assert [k for k, _ in seen].count("replay") == 2


def test_every_ctypes_entry_goes_through_the_launch_helper():
    """In the four kernel wrappers no C entry is called directly: the only
    calls of ``_lib(...)``'s and ``_entry()``'s results are the helper's."""
    for name in ("gn_attention", "gn_layernorm", "gn_paged_attention", "gn_softmax"):
        path = ROOT / "src" / "repro_torch" / "kernels" / name / "ops.py"
        tree = ast.parse(path.read_text())
        helper = 0
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            direct = isinstance(fn, ast.Call) or (
                isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Call)
                and isinstance(fn.value.func, ast.Name)
                and fn.value.func.id in ("_lib", "_entry"))
            assert not direct, f"{path.name}:{node.lineno} calls a C entry outside the helper"
            if isinstance(fn, ast.Attribute) and fn.attr == "launch" and isinstance(
                    fn.value, ast.Name) and fn.value.id == "_build":
                helper += 1
        assert helper >= 1, name

