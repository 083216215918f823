"""The SSM and hybrid families (xlstm-350m: mLSTM; zamba2-7b: Mamba2 with one
shared attention block a group) served by the port on the CPU against the
JAX package: ``reduce_config`` at float32 (zamba2 at 4 layers in 2 groups),
the port's weights converted from the JAX ones.

  * the static path: ``forward``, ``prefill`` and ``decode_step`` logits
    within 1e-5, the carries (and the hybrid's shared K/V) the prefill
    leaves within 1e-5, ``generate`` tokens equal to the JAX package's;
  * ``ContinuousEngine`` over the slab pool (the automatic pool: these
    families do not page), chunk 4, 2 slots, on the chunk-boundary prompts
    of ``tests/test_serve_fused.py`` (6, 10, 3, 8 tokens): greedy tokens,
    ``event_log``, completions and the shared metrics equal to the JAX
    engine's, ``kv_hbm_bytes`` its, and the tokens equal to the port's
    ``static_reference``; a reset replay equal;
  * preemption on carries: spill (the slot's carries copied out and back)
    and recompute (a re-prefill from ``fresh_request_cache``) resumes equal
    to the JAX engine's runs and to the static oracle;
  * snapshots in both directions: the JAX engine writes after every tick and
    the port restores mid-run and drains to the JAX run; the port writes and
    the JAX engine restores and drains to it.  The reference ticks a free
    slot with token 0 at position 0, so its free slots' carries drift, where
    the port parks them: the carries are compared on live slots only
    (within 1e-5, the port's snapshot against the JAX one of the same tick);
    a restored free slot's stale carries are never read, since admission
    copies a fresh cache over the whole slot;
  * the reference's refusals of the slab options, and of paging; a fresh
    request cache (the mLSTM stabilizer at -1e30) and the slot pool over
    carries; the static decode step's warm-up before its graph capture
    leaves the carries as it found them;
  * the launchers: ``launch.serve --continuous`` on the CPU at f32 equal to
    its static oracle, and ``launch.train --smoke``: four finite losses and
    a checkpoint.

The JAX engines run once (module fixture): one per family, its policy set
between workloads (``_torch_parity.set_policy``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.checkpoint import store
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate, static_reference
from repro_torch.serve.kv_cache import SlotKVPool
from repro_torch.serve.workload import required_max_seq

from _torch_parity import (SFAMILIES, assert_same, jax_engine, pair, port_engine, run,
                           set_policy, summary, to_port)

LENS = (6, 10, 3, 8)
ATOL = 1e-5


def _requests(vocab):
    rng = np.random.default_rng(200)
    return [JaxRequest(id=i, tokens=rng.integers(0, vocab, size=n).astype(np.int32),
                       max_new_tokens=5, arrival_step=i) for i, n in enumerate(LENS)]


def _preempt_requests(vocab):
    """Two batch requests fill both slots; an interactive one arrives
    mid-decode with no slot free (``tests/test_torch_slab.py``)."""
    rng = np.random.default_rng(400)
    batch = [JaxRequest(id=i, tokens=rng.integers(0, vocab, size=9 + i).astype(np.int32),
                        max_new_tokens=10, arrival_step=0, req_class="batch") for i in range(2)]
    return batch + [JaxRequest(id=2, tokens=rng.integers(0, vocab, size=6).astype(np.int32),
                               max_new_tokens=4, arrival_step=8, req_class="interactive")]


def _kw(reqs):
    return {"num_slots": 2, "max_seq": max(required_max_seq(reqs), 24), "sched": "priority",
            "preempt": "spill"}


def _fingerprint(eng):
    return ([(c.request_id, tuple(int(t) for t in c.new_tokens), c.finish_reason,
              c.finish_step) for c in eng.completions],
            [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
             for e in eng.event_log], eng.step_count)


def _write_everywhere(eng, reqs, path):
    """Run ``reqs`` with a snapshot after every tick: (summary, fingerprint,
    steps)."""
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.step():
        eng.snapshot(path)
        steps.append(eng.step_count)
    return summary(eng, eng.completions), _fingerprint(eng), steps


def _drain_from(eng, path, step):
    eng.restore(path, step=step)
    while eng.step():
        pass
    return _fingerprint(eng)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX slab engine's run of the chunk-boundary workload,
    snapshotting after every tick; its spill and recompute runs of the
    preemption workload; the JAX static path's tokens."""
    out = {}
    for family, arch in SFAMILIES.items():
        jmodel, jparams, _, _ = pair(arch)
        reqs = _requests(jmodel.cfg.vocab)
        eng = jax_engine(jmodel, jparams, **_kw(reqs))
        path = tmp_path_factory.mktemp(family)
        res = {"snap": (path, *_write_everywhere(eng, reqs, path)[1:])}
        res["main"] = summary(eng, eng.completions)
        pre = _preempt_requests(jmodel.cfg.vocab)
        for mode in ("spill", "recompute"):
            res[mode] = run(set_policy(eng, preempt_mode=mode), pre)
        toks = np.stack([r.tokens for r in reqs if len(r.tokens) == 6] * 2)
        res["generate"] = np.array(jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                                                  JaxServeConfig(max_new_tokens=5)))
        out[family] = res
    return out


# ------------------------------------------------------------ static path --
@pytest.mark.parametrize("family", list(SFAMILIES))
def test_static_path_matches_jax(runs, family):
    jmodel, jparams, model, master = pair(SFAMILIES[family])
    params = model.prepare(master, "cpu")
    toks = np.random.default_rng(9).integers(0, 256, size=(2, 9)).astype(np.int32)
    want_f = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})[0]
    want_p, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 12)
    nxt = np.array([[7], [11]], np.int32)
    want_d, jcache2 = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), 9)
    with torch.no_grad():
        got_f = model.forward(params, {"tokens": torch.as_tensor(toks)})
        got_p, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)}, 12)
        leaves = {k: v.clone() for k, v in cache.items()}
        got_d, _ = model.decode_step(params, cache, torch.as_tensor(nxt), 9)
    for got, want in ((got_f, want_f), (got_p, want_p), (got_d, want_d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    from repro_torch.serve.engine import _leaf_path
    for name, leaf in leaves.items():
        node = jcache
        for key in _leaf_path(name).split("/"):
            node = node[int(key) if key.isdigit() else key]
        np.testing.assert_allclose(leaf.float().numpy(), np.asarray(node, np.float32),
                                   atol=ATOL, rtol=0, err_msg=name)
    six = np.asarray(runs[family]["generate"])[:, :6]
    out = generate(model, params, {"tokens": torch.as_tensor(six)},
                   ServeConfig(max_new_tokens=5))
    assert np.array_equal(out.numpy(), runs[family]["generate"])


# ------------------------------------------------------------ slab engine --
@pytest.mark.parametrize("family", list(SFAMILIES))
def test_slab_engine_equals_jax_and_the_oracle(runs, family):
    _, _, model, master = pair(SFAMILIES[family])
    reqs = to_port(_requests(model.cfg.vocab))
    eng = port_engine(model, master, **_kw(reqs))
    assert not eng.paged and not eng.sentinels
    got = run(eng, reqs)
    assert_same(got, runs[family]["main"])
    m = got["metrics"]
    assert m["read_path"] == "slab" and m["kv_hbm_bytes"] == runs[family]["main"]["metrics"][
        "kv_hbm_bytes"] == eng.pool.hbm_bytes()
    oracle = static_reference(model, eng.params, reqs, ServeConfig())
    for r in reqs:
        assert list(r.tokens) + got["tokens"][r.id] == oracle[r.id].tolist(), r.id
    eng.reset()
    assert run(eng, to_port(_requests(model.cfg.vocab)))["tokens"] == got["tokens"]


@pytest.mark.parametrize("family", list(SFAMILIES))
@pytest.mark.parametrize("mode", ["spill", "recompute"])
def test_preempt_resume_on_carries(runs, family, mode):
    _, _, model, master = pair(SFAMILIES[family])
    reqs = to_port(_preempt_requests(model.cfg.vocab))
    eng = port_engine(model, master, **{**_kw(reqs), "preempt": mode})
    got = run(eng, reqs)
    assert_same(got, runs[family][mode])
    assert got["metrics"]["preemptions"] >= 1 and got["metrics"]["preempt_resumes"] >= 1
    oracle = static_reference(model, eng.params, reqs, ServeConfig())
    for r in reqs:
        assert list(r.tokens) + got["tokens"][r.id] == oracle[r.id].tolist(), r.id


# -------------------------------------------------------------- snapshots --
def _live_carries(path, step):
    """The cache leaves of a snapshot, each cut to its live slots (slot
    axis 1)."""
    flat, manifest = store.restore_flat(path, step)
    live = sorted(int(s) for s in manifest["extra"]["slots"])
    return {k: v[:, live].float().numpy() for k, v in flat.items() if k.startswith("cache/")}


@pytest.mark.parametrize("family", list(SFAMILIES))
def test_jax_snapshot_restores_into_the_port(runs, family, tmp_path):
    _, _, model, master = pair(SFAMILIES[family])
    path, want, steps = runs[family]["snap"]
    reqs = to_port(_requests(model.cfg.vocab))
    restorer = port_engine(model, master, **_kw(reqs))
    for step in (steps[1], steps[len(steps) // 2], steps[-2]):
        assert _drain_from(restorer, path, step) == want, f"diverged from tick {step}"
    # the port's own snapshots of the same run: live slots' carries as JAX's
    writer = port_engine(model, master, **_kw(reqs))
    _, mine, my_steps = _write_everywhere(writer, reqs, tmp_path)
    assert (mine, my_steps) == (want, steps)
    for step in (steps[1], steps[len(steps) // 2]):
        got, ref = _live_carries(tmp_path, step), _live_carries(path, step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("family", list(SFAMILIES))
def test_port_snapshot_restores_into_jax(runs, family, tmp_path):
    jmodel, jparams, model, master = pair(SFAMILIES[family])
    reqs = to_port(_requests(model.cfg.vocab))
    _, want, steps = _write_everywhere(port_engine(model, master, **_kw(reqs)), reqs, tmp_path)
    assert want == runs[family]["snap"][1]
    restorer = JaxEngine(jmodel, jparams, cfg=JaxServeConfig(), chunk=4, **_kw(reqs))
    for step in (steps[2], steps[-3]):
        assert _drain_from(restorer, tmp_path, step) == want, f"diverged from tick {step}"


# ---------------------------------------------------------------- refusals --
@pytest.mark.parametrize("kw,err", [
    ({"paged": True}, "no pageable KV"),
    ({"kv_dtype": "int8"}, "fp-only"),
    ({"prefix_cache": True}, "prefix_cache"),
    ({"block_size": 4}, "block_size/num_blocks"),
    ({"num_blocks": 8}, "block_size/num_blocks"),
    ({"sentinels": True}, "sentinels"),
])
def test_slab_refusals_as_the_reference(kw, err):
    for arch in SFAMILIES.values():
        _, _, model, master = pair(arch)
        with pytest.raises(ValueError, match=err):
            ContinuousEngine(model, master, num_slots=2, max_seq=32, cfg=ServeConfig(),
                             device="cpu", **kw)
        with pytest.raises(ValueError, match="no pageable KV"):
            model.init_paged_cache(4, 4, "cpu")


@pytest.mark.parametrize("family", list(SFAMILIES))
def test_fresh_cache_and_the_slot_pool(family):
    _, _, model, _ = pair(SFAMILIES[family])
    fresh = model.fresh_request_cache(16, "cpu")
    for name, leaf in fresh.items():
        assert torch.equal(leaf, torch.full_like(leaf, -1e30 if name == "m" else 0.0)), name
    pool = SlotKVPool(model, num_slots=3, max_seq=16, device="cpu")
    assert pool.hbm_bytes() == sum(t.numel() * t.element_size() for t in pool.caches[0].values())
    assert set(pool.caches[0]) == set(model.carry_leaves) | (
        {"shared_k", "shared_v"} if family == "hybrid" else set())
    slot = pool.allocate()
    row = {k: torch.randn(v[:, :1].shape).to(v.dtype) for k, v in pool.caches[0].items()}
    pool.insert(row, slot, position=3)
    assert all(torch.equal(pool.extract(slot)[k], row[k]) for k in row)


@pytest.mark.parametrize("family", list(SFAMILIES))
def test_static_decode_warmup_puts_the_carries_back(family):
    """The static decode step's warm-up before its graph capture runs the
    step once: it leaves the carries as it found them (a replay then
    advances them once) and writes the shared K/V the replay writes again."""
    _, _, model, master = pair(SFAMILIES[family])
    params = model.prepare(master, "cpu")
    dec = engine_mod._StaticDecode(model, params, 2, 12, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 5)), dtype=torch.int32)
    model.prefill(params, {"tokens": toks}, 12, cache=dec.cache)
    dec.token.fill_(7)
    dec.pos.fill_(5)
    before = {k: v.clone() for k, v in dec.cache.items()}
    with torch.no_grad():
        dec._warmup()
        after = {k: v.clone() for k, v in dec.cache.items()}
        want = dec._step()
    for k in model.carry_leaves:
        assert torch.equal(after[k], before[k]), k
    for k, v in dec.cache.items():
        if k not in model.carry_leaves:
            assert torch.equal(after[k], v), k  # the replay writes the same K/V
    assert not all(torch.equal(dec.cache[k], before[k]) for k in model.carry_leaves)
    assert torch.isfinite(want).all()


# --------------------------------------------------------------- launchers --
@pytest.mark.parametrize("family", list(SFAMILIES))
def test_launchers_serve_and_train(family, tmp_path):
    arch = SFAMILIES[family]
    out = serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--continuous",
                               "--dtype", "float32", "--requests", "4", "--new-tokens", "4",
                               "--min-prompt", "3", "--max-prompt", "10", "--chunk", "4"])
    assert not out["engine"].paged and out["static_identical"] == 4
    train_launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
                         "--seq", "16", "--batch", "2", "--outdir", str(tmp_path)])
    losses = [json.loads(line)["loss"]
              for line in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert store.latest_step(tmp_path / "ckpt") == 4
