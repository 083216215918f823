"""Crash-consistent engine snapshots of the port on the CPU (the reference's
``tests/test_serve_snapshot.py``), and across the two packages: reduced f32
internlm2-1.8b (dense) and minicpm3-4b (MLA), weights converted from the
JAX ones, chunk 4, 2 slots, max_seq 64.

  * kill at every tick: a writer snapshots after every step, and one
    restorer restores each snapshot and drains; every drain equals the
    writer's (completions, finish steps, event log, step count) over the
    paged fp, paged int8, slab and MLA paged pools, and a sampled run;
  * the JAX engine writes, the port restores (2-3 ticks a pool) and drains
    to the JAX writer's tokens and event log; the port writes and the JAX
    engine restores (paged fp): the snapshot format is the reference's;
  * quarantined blocks restore as quarantined and the ledger reconciles;
    a topology mismatch, an attached prefix cache and a missing snapshot
    are refused as the reference refuses them; a torn save never shadows
    the latest snapshot.
"""
import numpy as np
import pytest

from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.checkpoint import store
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.scheduler import Request

from _torch_parity import FAMILIES, pair

CHUNK = 4
POOLS = {"paged_fp": ("dense", {}), "paged_int8": ("dense", {"kv_dtype": "int8"}),
         "slab": ("dense", {"paged": False}), "mla_paged": ("mla", {})}


def _requests(cls, lens=(5, 9, 7), max_new=5, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [cls(tokens=rng.integers(0, 256, size=n).astype(np.int32), max_new_tokens=max_new,
                **kw) for n in lens]


def _fingerprint(eng):
    return ([(c.request_id, tuple(int(t) for t in c.prompt_tokens),
              tuple(int(t) for t in c.new_tokens), c.finish_reason, c.finish_step,
              c.preemptions) for c in eng.completions],
            [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
             for e in eng.event_log],
            eng.step_count)


def _port(family, max_new=5, temperature=0.0, **kw):
    _, _, model, master = pair(FAMILIES[family])
    return ContinuousEngine(model, master, num_slots=2, max_seq=64, chunk=CHUNK, device="cpu",
                            cfg=ServeConfig(max_new_tokens=max_new, temperature=temperature),
                            **kw)


def _jax(family, **kw):
    jmodel, jparams, _, _ = pair(FAMILIES[family])
    return JaxEngine(jmodel, jparams, num_slots=2, max_seq=64, chunk=CHUNK,
                     cfg=JaxServeConfig(max_new_tokens=5), **kw)


def _write_everywhere(eng, reqs, path):
    """Run ``reqs`` with a snapshot after every tick: (fingerprint, steps)."""
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.step():
        eng.snapshot(path)
        steps.append(eng.step_count)
    return _fingerprint(eng), steps


def _drain_from(eng, path, step):
    eng.restore(path, step=step)
    while eng.step():
        pass
    return _fingerprint(eng)


@pytest.mark.parametrize("pool", list(POOLS))
def test_kill_at_every_tick_resumes_identically(pool, tmp_path):
    family, kw = POOLS[pool]
    want, steps = _write_everywhere(_port(family, **kw), _requests(Request), tmp_path)
    assert len(steps) >= 5
    restorer = _port(family, **kw)
    for step in steps:
        assert _drain_from(restorer, tmp_path, step) == want, f"diverged from tick {step}"


def test_sampled_run_resumes_identically(tmp_path):
    """The counter-keyed sampler needs no key: a sampled resume is exact."""
    want, steps = _write_everywhere(_port("dense", temperature=0.7),
                                    _requests(Request, seed=3), tmp_path)
    restorer = _port("dense", temperature=0.7)
    for step in steps[::3]:
        assert _drain_from(restorer, tmp_path, step) == want, f"diverged from tick {step}"


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    """Per pool, the JAX writer's snapshots (one every tick) and its
    fingerprint."""
    out = {}
    for pool, (family, kw) in POOLS.items():
        path = tmp_path_factory.mktemp(pool)
        out[pool] = (path, *_write_everywhere(_jax(family, **kw), _requests(JaxRequest), path))
    return out


@pytest.mark.parametrize("pool", list(POOLS))
def test_jax_snapshot_restores_into_the_port(jax_snapshots, pool):
    family, kw = POOLS[pool]
    path, want, steps = jax_snapshots[pool]
    restorer = _port(family, **kw)
    for step in (steps[1], steps[len(steps) // 2], steps[-2]):
        assert _drain_from(restorer, path, step) == want, f"diverged from tick {step}"


def test_port_snapshot_restores_into_jax(jax_snapshots, tmp_path):
    want, steps = _write_everywhere(_port("dense"), _requests(Request), tmp_path)
    assert want == jax_snapshots["paged_fp"][1]  # the same run in both packages
    restorer = _jax("dense")
    for step in (steps[1], steps[len(steps) // 2]):
        assert _drain_from(restorer, tmp_path, step) == want, f"diverged from tick {step}"
    # the leaves carry the reference's names, the write-sink block left out
    flat, manifest = store.restore_flat(tmp_path, steps[1])
    eng = _port("dense")
    nb = eng.pool.num_blocks
    assert flat["cache/layers/k"].shape[1] == nb == manifest["extra"]["topology"]["num_blocks"]
    assert flat["key"].tolist() == [0, 0]  # the reference's PRNGKey(0)


def test_snapshot_preserves_quarantine_and_ledger(tmp_path):
    reqs = _requests(Request, lens=(5, 9, 7, 6), max_new=4)
    eng = _port("dense", max_new=4)
    inj = FaultInjector(eng, seed=1)
    for r in reqs:
        eng.submit(r)
    injected = 0
    while not eng.pool.quarantined:
        assert eng.step(), "drained before any quarantine happened"
        if injected < 3 and inj.inject("nan_tile"):
            injected += 1
    eng.snapshot(tmp_path)
    quarantined, retries = set(eng.pool.quarantined), dict(eng._fault_retries)
    fresh = _port("dense", max_new=4)
    fresh.restore(tmp_path)
    assert fresh.pool.quarantined == quarantined and fresh._fault_retries == retries
    fresh.pool.check_ledger()
    while fresh.step():
        fresh.pool.check_ledger()
        assert quarantined <= fresh.pool.quarantined
    assert len(fresh.completions) == len(reqs)


def test_restore_refuses_topology_mismatch_prefix_cache_and_missing(tmp_path):
    eng = _port("dense", max_new=4)
    eng.submit(_requests(Request, lens=(5,), max_new=4)[0])
    eng.step()
    eng.snapshot(tmp_path / "snap")
    other = ContinuousEngine(eng.model, pair(FAMILIES["dense"])[3], num_slots=4, max_seq=64,
                             chunk=CHUNK, device="cpu", cfg=ServeConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match="topology.*num_slots"):
        other.restore(tmp_path / "snap")
    with pytest.raises(ValueError, match="prefix"):
        _port("dense", prefix_cache=True).snapshot(tmp_path / "other")
    with pytest.raises(FileNotFoundError):
        eng.restore(tmp_path / "nowhere")


def test_torn_save_never_shadows_latest(tmp_path):
    eng = _port("dense", max_new=4)
    eng.submit(_requests(Request, lens=(5,), max_new=4)[0])
    eng.step()
    eng.snapshot(tmp_path)
    good = store.latest_step(tmp_path)
    torn = tmp_path / f".tmp_step_{good + 1:08d}"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"torn")
    assert store.latest_step(tmp_path) == good
    eng.step()
    eng.snapshot(tmp_path)
    assert not torn.exists() and store.latest_step(tmp_path) > good
