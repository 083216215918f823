"""The port's radix prefix cache on the CPU against the JAX package: the
one-device paged dense cases of the reference's tests/test_serve_prefix.py,
held to the JAX engine or pool on the same converted weights and tokens.

  * engine (reduced internlm2-1.8b, f32, chunk 4, 2 slots, sentinels on):
    greedy tokens, ``event_log``, ``request_prefix_hits``, completions, the
    shared ``metrics()`` keys and the final block tables and refcounts equal
    the JAX engine's on the shared-prefix workload at block sizes 4 and 8,
    over the int8 pool, on a tight arena whose readmissions evict (the
    subtree-cut fallback), on a divergent-tail workload (COW forks), and on a
    reset replay; the tokens equal the static oracle's; the port's kernel
    read (the reference's "pallas") and its streamed and gathered reads all
    serve the JAX engine's tokens;
  * the MLA family (reduced minicpm3-4b, latent arenas): the engine's
    shared-prefix runs at block sizes 4 and 8 equal the JAX engine's, and
    the fork and spill cases below over its fp and int8 latent pools;
  * pool: a fork copies its source block bit for bit in every leaf and
    touches no other block (fp and int8, the scales with the arenas),
    ``ensure`` is host-only, the write barrier refuses a shared block;
    refcounted recycling and leaf-first LRU eviction; admission charging the
    unshared tail; the lookup cap and the stamp-free hint; each step's
    refcounts, tables and free list equal the JAX pool's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import static_reference as jax_static_reference
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.kv_cache import BlockPagedKVPool as JaxPool
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.workload import required_max_seq, shared_prefix_requests
from repro_torch.models import attention as t_attn
from repro_torch.serve.engine import ServeConfig, static_reference
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.prefix_cache import PrefixCache

from _torch_parity import (CHUNK, FAMILIES, assert_same, dense, jax_engine, pair, port_engine,
                           prompt, run, to_port)


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None


def _shared_reqs(cfg, **kw):
    # the reference test's workload: system + persona = 18 tokens, block
    # misaligned at block sizes 4 and 8, so later arrivals fork
    kw = {"n_users": 6, "n_personas": 2, "system_len": 12, "persona_len": 6, "user_len": 5,
          "max_new_tokens": 4, "stagger": 7, **kw}
    return shared_prefix_requests(cfg, **kw)


def _cow_reqs(cfg):
    """A 13-token shared prefix that diverges mid-block, then a full match."""
    base = prompt(cfg.vocab, 16, seed=900)
    div = base.copy()
    div[13:] = (div[13:] + 1) % cfg.vocab
    return [JaxRequest(id=0, tokens=base, max_new_tokens=4, arrival_step=0),
            JaxRequest(id=1, tokens=div, max_new_tokens=4, arrival_step=20),
            JaxRequest(id=2, tokens=base.copy(), max_new_tokens=4, arrival_step=40)]


MAX_SEQ = 32  # covers both workloads: 23 + 4 and 16 + 4 tokens


def _roomy(bs):
    """The reference test's roomy arena: twice the slab-equivalent blocks."""
    return 2 * 2 * -(-MAX_SEQ // bs)


@pytest.fixture(scope="module")
def runs():
    """The JAX engines' runs: the shared-prefix workload at block sizes 4 and
    8 and over the int8 pool, the COW workload and a reset replay on the
    block-size-4 engine, the tight arena (stagger 3, the slab-equivalent
    arena); and the JAX static oracle's tokens."""
    jmodel, jparams, model, master = dense()
    cfg = jmodel.cfg
    shared, cow = _shared_reqs(cfg), _cow_reqs(cfg)
    tight = _shared_reqs(cfg, stagger=3)
    out = {"model": model, "master": master, "jmodel": jmodel,
           "reqs": {"shared": shared, "cow": cow, "tight": tight}}
    eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=MAX_SEQ, block_size=4,
                     num_blocks=_roomy(4), prefix_cache=True)
    out["shared", 4] = run(eng, shared)
    eng.reset()
    out["replay", 4] = run(eng, shared)
    eng.reset()
    out["cow", 4] = run(eng, cow)
    eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=MAX_SEQ, block_size=8,
                     num_blocks=_roomy(8), prefix_cache=True)
    out["shared", 8] = run(eng, shared)
    eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=MAX_SEQ, block_size=4,
                     num_blocks=_roomy(4), prefix_cache=True, kv_dtype="int8")
    out["shared", "int8"] = run(eng, shared)
    eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=required_max_seq(tight),
                     block_size=4, prefix_cache=True)
    out["tight", 4] = run(eng, tight)
    out["oracle"] = {}
    for name in ("shared", "cow", "tight"):
        ref = jax_static_reference(jmodel, jparams, out["reqs"][name], JaxServeConfig())
        out["oracle"][name] = {i: np.asarray(t).tolist() for i, t in ref.items()}
    return out


@pytest.fixture(scope="module")
def mla_runs():
    """The MLA family's (reduced minicpm3-4b) JAX engine runs of the
    shared-prefix workload at block sizes 4 and 8, and the port's static
    oracle of it; the models for the pool tests."""
    jmodel, jparams, model, master = pair(FAMILIES["mla"])
    shared = _shared_reqs(jmodel.cfg)
    out = {"model": model, "master": master, "jmodel": jmodel, "reqs": {"shared": shared}}
    for bs in (4, 8):
        eng = jax_engine(jmodel, jparams, num_slots=2, max_seq=MAX_SEQ, block_size=bs,
                         num_blocks=_roomy(bs), prefix_cache=True)
        out["shared", bs] = run(eng, shared)
    oracle = static_reference(model, model.prepare(master, "cpu"), to_port(shared),
                              ServeConfig())
    out["oracle"] = {"shared": {i: t.tolist() for i, t in oracle.items()}}
    return out


def _family(request, runs, family):
    """The dense runs, or the MLA family's."""
    return runs if family == "dense" else request.getfixturevalue("mla_runs")


def _port(runs, name, bs=4, **kw):
    kw = {"num_slots": 2, "max_seq": MAX_SEQ, "block_size": bs, "num_blocks": _roomy(bs),
          "prefix_cache": True, **kw}
    eng = port_engine(runs["model"], runs["master"], **kw)
    return eng, run(eng, to_port(runs["reqs"][name]))


def _oracle_identical(got, runs, name):
    reqs = {r.id: r for r in runs["reqs"][name]}
    for rid, toks in got["tokens"].items():
        assert list(reqs[rid].tokens) + toks == runs["oracle"][name][rid], f"req {rid}"


# ----------------------------------------- greedy identity, cache on --------
@pytest.mark.parametrize("bs", [CHUNK, 2 * CHUNK])
@pytest.mark.parametrize("family", ["dense", "mla"])
def test_prefix_engine_equals_jax_engine(request, runs, family, bs):
    runs = _family(request, runs, family)
    eng, got = _port(runs, "shared", bs)
    assert_same(got, runs["shared", bs])
    _oracle_identical(got, runs, "shared")
    m = got["metrics"]
    assert m["prefix_cache"] is True
    # every request after the first shares at least the system prompt, and
    # the 18-token shared prefix sits mid-block: COW forks fired
    assert m["prefix_hit_requests"] == 5 and m["prefix_hit_rate"] > 0 and m["prefix_forks"] > 0
    # drained: slots free, the cache keeps its chains (one reference each)
    assert eng.pool.num_free == eng.pool.num_slots
    assert eng.pool.blocks_in_use == eng.pool.cached_blocks > 0
    held = np.flatnonzero(eng.pool.refcounts)
    assert (eng.pool.refcounts[held] == 1).all()
    eng.pool.check_ledger()


def test_prefix_engine_int8_equals_jax_engine(runs):
    """The int8 pool: the forked tail block carries its donor's frozen
    scale, and the tokens, hits and tables equal the JAX int8 engine's."""
    _, got = _port(runs, "shared", kv_dtype="int8")
    assert_same(got, runs["shared", "int8"])
    assert got["metrics"]["prefix_forks"] > 0


@pytest.mark.parametrize("path", ["streamed", "gathered", None])
def test_prefix_identity_across_read_paths(runs, path):
    """Sharing is exact through every paged read: the kernel read (the
    reference's "pallas"), the streamed and the gathered read walk the same
    tables the prefix cache filled."""
    t_attn.FORCE_PAGED_READ = path
    eng, got = _port(runs, "shared")
    assert eng.metrics()["read_path"] == (path or "kernel")
    assert_same(got, runs["shared", 4])


def test_tight_arena_identity_under_eviction_churn(runs):
    """The slab-equivalent arena (two full footprints): readmission must
    evict cached chains, and a live slot's prefill-completion insert pins
    descendants under refcount-1 ancestors, which only the subtree cut
    reclaims."""
    eng, got = _port(runs, "tight", max_seq=required_max_seq(runs["reqs"]["tight"]),
                     num_blocks=0)
    assert_same(got, runs["tight", 4])
    _oracle_identical(got, runs, "tight")
    assert got["metrics"]["num_blocks"] == 2 * eng.pool.max_blocks_per_slot
    assert got["metrics"]["prefix_evictions"] > 0


def test_cow_fork_on_divergent_tail(runs):
    _, got = _port(runs, "cow")
    assert_same(got, runs["cow", 4])
    _oracle_identical(got, runs, "cow")
    hits = got["hits"]
    assert 0 not in hits  # the donor paid the full prefill
    assert hits[1]["tokens"] == 13 and hits[1]["forked"] is True
    # capped at prompt_len - 1 = 15: three full blocks and a forked tail
    assert hits[2]["tokens"] == 15 and hits[2]["forked"] is True
    assert got["metrics"]["prefix_forks"] == 2


def test_reset_replays_identical_hits_and_tokens(runs):
    eng, first = _port(runs, "shared")
    eng.reset()
    assert eng.pool.blocks_in_use == 0 and eng.prefix.cached_blocks() == 0
    again = run(eng, to_port(runs["reqs"]["shared"]))
    assert_same(again, first)
    assert_same(again, runs["replay", 4])


def test_unaligned_shared_start_repads_the_prompt(runs):
    """A hit whose shared length is not chunk-aligned starts the prefill
    mid-grid: the admission re-pads the prompt so that its last chunk is
    whole (the intake's grid padding would be short)."""
    eng = port_engine(runs["model"], runs["master"], num_slots=2, max_seq=MAX_SEQ, block_size=4,
                      num_blocks=_roomy(4), prefix_cache=True)
    reqs = to_port(runs["reqs"]["cow"])
    for r in reqs:
        eng.submit(r)
    while eng.step():
        for st in eng._slots:
            if st is not None and st.phase == "prefilling":
                assert st.padded.shape[0] >= st.written + CHUNK
    assert eng.request_prefix_hits[1]["tokens"] % CHUNK == 1


# ------------------------------------------------------ pools, both sides --
class _Side:
    """One package's pool and radix cache behind one interface: both key
    their index and ledger by device, as the reference does (always 0
    here)."""

    def __init__(self, pool, cache, jax_side: bool):
        self.pool, self.cache, self.jax = pool, cache, jax_side
        pool.attach_prefix_cache(cache)

    def insert(self, tokens, chain):
        self.cache.insert(tokens, chain, 0)

    def evictable(self):
        return self.cache.evictable_count(0, self.pool.refcounts)

    def can_reserve(self, tokens, prefix=None):
        return self.pool.can_reserve(tokens, 0, prefix=prefix)

    def free_blocks(self):
        return list(self.pool._free_blocks[0])

    def unfilled(self):
        return self.pool.unfilled_on(0)

    def state(self):
        return (np.array(self.pool.refcounts).tolist(), np.array(self.pool.tables).tolist(),
                self.free_blocks(), int(self.pool.prefix_forks), int(self.pool.prefix_evictions),
                self.cache.hits, self.cache.misses, self.cache.inserts, self.cache.evictions)


def _sides(runs, **kw):
    jax_pool = JaxPool(runs["jmodel"], **kw)
    port_pool = BlockPagedKVPool(runs["model"], device="cpu", **kw)
    bs = kw["block_size"]
    return _Side(jax_pool, JaxPrefixCache(bs), True), _Side(port_pool, PrefixCache(bs), False)


def _both(sides, script):
    """Run ``script(side)`` on both sides; its yields are states, equal."""
    got = [list(script(side)) for side in sides]
    assert got[0] == got[1]
    return got[1]


def test_refcount_recycle_and_lru_eviction(runs):
    vocab = runs["model"].cfg.vocab
    tokens = prompt(vocab, 16, seed=902)

    def script(side):
        pool, cache = side.pool, side.cache
        s0 = pool.allocate(reserve_tokens=16)
        pool.ensure(s0, 16)
        chain = pool.chain_of(s0)
        assert all(pool.refcounts[b] == 1 for b in chain)
        side.insert(tokens, chain)
        assert all(pool.refcounts[b] == 2 for b in chain) and cache.cached_blocks() == 4
        yield side.state()
        pool.free(s0)  # the owner finishes: the cache keeps the blocks
        assert all(pool.refcounts[b] == 1 for b in chain)
        assert pool.blocks_in_use == 4 and len(side.free_blocks()) == 4
        hit = cache.lookup(tokens)
        assert hit.blocks == chain and hit.shared_len == 16 and hit.tail_src is None
        s1 = pool.allocate(reserve_tokens=20, prefix=hit)
        pool.attach_prefix(s1, hit)
        assert all(pool.refcounts[b] == 2 for b in chain)
        pool.ensure(s1, 20)  # pops exactly the one unshared block
        assert pool.chain_of(s1)[:4] == chain and len(pool.chain_of(s1)) == 5
        yield side.state()
        pool.free(s1)
        assert pool.blocks_in_use == 4
        # block pressure: 6 blocks wanted, 4 free -> two LRU cache-only
        # blocks reclaimed leaf first; the surviving prefix stays matchable
        s2 = pool.allocate(reserve_tokens=24)
        pool.ensure(s2, 24)
        assert pool.prefix_evictions == 2 and cache.evictions == 2 and cache.cached_blocks() == 2
        surviving = cache.lookup(tokens, touch=False)
        assert surviving.shared_len == 8 and surviving.blocks == chain[:2]
        yield side.state()
        pool.free(s2)
        assert pool.blocks_in_use == 2
        assert sorted(np.flatnonzero(pool.refcounts).tolist()) == sorted(chain[:2])
        yield side.state()

    _both(_sides(runs, num_slots=3, max_seq=32, block_size=4, num_blocks=8), script)


def test_admission_charges_only_unshared_tail(runs):
    """With the donor live (nothing evictable) a 24-token footprint needs 6
    blocks and 2 are free: admission fits only because 4 attach."""
    tokens = prompt(runs["model"].cfg.vocab, 16, seed=903)

    def script(side):
        pool, cache = side.pool, side.cache
        s0 = pool.allocate(reserve_tokens=16)
        pool.ensure(s0, 16)
        chain = pool.chain_of(s0)
        side.insert(tokens, chain)
        assert len(side.free_blocks()) == 2 and side.evictable() == 0
        hit = cache.lookup(tokens)
        assert not side.can_reserve(24) and side.can_reserve(24, prefix=hit)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.allocate(reserve_tokens=24)
        s1 = pool.allocate(reserve_tokens=24, prefix=hit)
        assert int(pool._reserved[s1]) == 2
        pool.attach_prefix(s1, hit)
        pool.ensure(s1, 24)
        assert int(pool._owned[s1]) == 2 and int(pool._shared[s1]) == 4
        assert side.unfilled() == 0
        assert all(pool.refcounts[b] == 3 for b in chain)  # owner + sharer + cache
        yield side.state()
        pool.free(s0)
        pool.free(s1)
        assert pool.blocks_in_use == 4
        yield side.state()

    _both(_sides(runs, num_slots=3, max_seq=32, block_size=4, num_blocks=6), script)


def test_radix_cap_and_stampfree_hint(runs):
    tokens = prompt(runs["model"].cfg.vocab, 16, seed=904)

    def script(side):
        pool, cache = side.pool, side.cache
        s0 = pool.allocate(reserve_tokens=16)
        pool.ensure(s0, 16)
        side.insert(tokens, pool.chain_of(s0))
        h0, m0, clock0 = cache.hits, cache.misses, cache._clock
        assert cache.match_len(tokens) == 16
        assert (cache.hits, cache.misses, cache._clock) == (h0, m0, clock0)
        hit = cache.lookup(tokens, cap=15)
        assert hit.shared_len == 15 and hit.tail_src == pool.chain_of(s0)[3]
        assert cache.hits == h0 + 1 and cache._clock > clock0
        assert cache.lookup(tokens, cap=0) is None and cache.misses == m0 + 1
        yield side.state(), (hit.blocks, hit.shared_len, hit.tail_src, hit.device)

    _both(_sides(runs, num_slots=2, max_seq=32, block_size=4, num_blocks=8), script)


def _fill_both(jax_side, port_side, rng):
    """The same random values in both pools' real blocks (int8 arenas take
    random int8, everything else random f32 of its own dtype)."""
    layers = dict(jax_side.pool.cache["layers"])
    for k, leaf in layers.items():
        if leaf.dtype == jnp.int8:
            vals = rng.integers(-127, 128, size=leaf.shape).astype(np.int8)
        else:
            vals = rng.uniform(0.01, 1.0, size=leaf.shape).astype(np.float32)
        layers[k] = jnp.asarray(vals).astype(leaf.dtype)
        port_leaf = port_side.pool.caches[0][k]
        port_leaf[:, :leaf.shape[1]] = torch.from_numpy(vals).to(port_leaf.dtype)
    jax_side.pool.cache = {**jax_side.pool.cache, "layers": layers}


def _real_blocks(side):
    """Each leaf as numpy, the port's write-sink block dropped."""
    if side.jax:
        return {k: np.asarray(v) for k, v in side.pool.cache["layers"].items()}
    nb = side.pool.num_blocks
    return {k: v[:, :nb].numpy() for k, v in side.pool.caches[0].items()}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("family", ["dense", "mla"])
def test_fork_copies_block_bitwise_and_preserves_arena(request, runs, family, kv_dtype):
    """``ensure`` is host-only; an attach-time fork copies its source block
    bit for bit in every leaf (the int8 pool's scales with its arenas; MLA's
    latent arenas) and leaves every other block and every live table as it
    was, as the JAX pool's fork does; the port's fork writes in place."""
    runs = _family(request, runs, family)
    sides = _sides(runs, num_slots=3, max_seq=32, block_size=4, num_blocks=12,
                   kv_dtype=kv_dtype)
    _fill_both(*sides, np.random.default_rng(3))
    tokens = prompt(runs["model"].cfg.vocab, 14, seed=901)
    ptrs = {k: v.data_ptr() for k, v in sides[1].pool.caches[0].items()}
    after = []
    for side in sides:
        pool, cache = side.pool, side.cache
        before = _real_blocks(side)
        s0 = pool.allocate(reserve_tokens=16)
        pool.ensure(s0, 16)
        chain0, table0 = pool.chain_of(s0), pool.tables[s0].copy()
        s1 = pool.allocate(reserve_tokens=8)
        pool.ensure(s1, 8)
        for k, v in _real_blocks(side).items():
            np.testing.assert_array_equal(v, before[k])
        assert pool.chain_of(s0) == chain0 and np.array_equal(pool.tables[s0], table0)
        side.insert(tokens, chain0)  # 3 full blocks and a 2-token tail
        pool.free(s0)
        pool.free(s1)
        hit = cache.lookup(tokens)
        assert hit.shared_len == 14 and hit.tail_src == chain0[3]
        s2 = pool.allocate(reserve_tokens=16, prefix=hit)
        pool.attach_prefix(s2, hit)
        dst = pool.chain_of(s2)[3]
        assert pool.prefix_forks == 1 and dst != hit.tail_src
        now = _real_blocks(side)
        for k, v in now.items():
            np.testing.assert_array_equal(v[:, dst], before[k][:, hit.tail_src], err_msg=k)
            keep = np.arange(v.shape[1]) != dst
            np.testing.assert_array_equal(v[:, keep], before[k][:, keep], err_msg=k)
        pool.write_barrier(s2, 14)  # the next write lands in the fork: fine
        with pytest.raises(RuntimeError, match="COW violation"):
            pool.write_barrier(s2, 8)  # block 2 is shared (refcount 2)
        after.append((now, side.state()))
    assert after[0][1] == after[1][1]
    for k in after[0][0]:
        np.testing.assert_array_equal(after[1][0][k], after[0][0][k])
    assert {k: v.data_ptr() for k, v in sides[1].pool.caches[0].items()} == ptrs


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("family", ["dense", "mla"])
def test_spill_restore_bitwise_into_another_chain(request, runs, family, kv_dtype):
    """``extract_blocks`` then ``restore_blocks`` into a different physical
    chain is bit for bit in every leaf (int8 arenas and scales; MLA's latent
    arenas); the payload (padded to a power of two with the last block
    repeated) equals the JAX pool's, and the restore writes in place."""
    runs = _family(request, runs, family)
    sides = _sides(runs, num_slots=3, max_seq=16, block_size=4, num_blocks=8,
                   kv_dtype=kv_dtype)
    _fill_both(*sides, np.random.default_rng(7))
    ptrs = {k: v.data_ptr() for k, v in sides[1].pool.caches[0].items()}
    payloads, restored = [], []
    for side in sides:
        pool = side.pool
        s0 = pool.allocate(reserve_tokens=12)
        pool.ensure(s0, 11)  # 3 blocks
        chain0 = pool.chain_of(s0)
        values0 = {k: v[:, chain0] for k, v in _real_blocks(side).items()}
        payload = pool.extract_blocks(s0)
        pool.free(s0)
        s_hold = pool.allocate(reserve_tokens=12)
        pool.ensure(s_hold, 11)  # the old chain is taken
        s1 = pool.allocate(reserve_tokens=12)
        pool.ensure(s1, 11)
        chain1 = pool.chain_of(s1)
        assert chain1 != chain0
        pool.restore_blocks(s1, payload)
        for k, v in _real_blocks(side).items():
            np.testing.assert_array_equal(v[:, chain1], values0[k], err_msg=k)
        payloads.append((payload["len"], {k: np.asarray(v) for k, v in payload["layers"].items()}))
        restored.append(_real_blocks(side))
    assert payloads[0][0] == payloads[1][0] == 3
    for k, v in payloads[0][1].items():
        assert v.shape[1] == 4  # padded to a power of two
        np.testing.assert_array_equal(payloads[1][1][k], v, err_msg=k)
        np.testing.assert_array_equal(restored[1][k], restored[0][k], err_msg=k)
    assert {k: v.data_ptr() for k, v in sides[1].pool.caches[0].items()} == ptrs
