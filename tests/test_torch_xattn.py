"""The encoder-decoder and VLM families (whisper-large-v3, llama-3.2-vision-11b)
against the JAX package on the CPU: ``reduce_config`` (encoder_seq 16,
num_patches 8) at float32, the port's weights converted from the JAX ones,
every VLM gate 0.5 (``_torch_parity.pair``: at its init value of 0 the VLM
ignores its patches), frames and patches drawn from a seed.

  * ``forward`` logits within 1e-5; ``encode_cross_kv`` and the static
    prefill's cross k/v and patches leaves within 1e-6;
  * the static ``generate``: greedy tokens equal;
  * ``ContinuousEngine`` over the paged pool (fp and int8) and the slab
    pool, chunk 4, 2 slots, on the chunk-boundary prompts of
    ``tests/test_serve_fused.py`` (6, 10, 3, 8 tokens): greedy tokens,
    ``event_log``, completions and the shared metrics equal to the JAX
    engine's, and the tokens equal to the port's ``static_reference``;
  * snapshots with extras: the JAX engine writes after every tick and the
    port restores mid-run and drains to the JAX run; the port writes and the
    JAX engine restores and drains to it (paged fp, and the slab); the
    request's frames or patches and the cache's cross/patches leaves travel
    under the reference's names.

The JAX engines of a module run once (module fixture), as in
``tests/test_torch_slab.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import engine as jax_engine_mod
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.checkpoint import store
from repro_torch.serve import engine
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.workload import required_max_seq

from _torch_parity import XFAMILIES, assert_same, pair, run, summary, to_port

CHUNK = 4
LENS = (6, 10, 3, 8)
POOLS = {"paged_fp": {}, "paged_int8": {"kv_dtype": "int8"}, "slab": {"paged": False}}
LOGITS_ATOL = 1e-5


def _extras(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.normal(size=(cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.normal(size=(cfg.num_patches, cfg.d_model)).astype(np.float32)}


def _jax_requests(cfg):
    rng = np.random.default_rng(200)
    return [JaxRequest(id=i, tokens=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                       max_new_tokens=5, arrival_step=i, extras=_extras(cfg, 300 + i))
            for i, n in enumerate(LENS)]


def _kw(reqs, pool):
    return {"num_slots": 2, "max_seq": required_max_seq(reqs), "chunk": CHUNK, **POOLS[pool]}


def _fingerprint(eng):
    return ([(c.request_id, tuple(int(t) for t in c.new_tokens), c.finish_reason,
              c.finish_step) for c in eng.completions],
            [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
             for e in eng.event_log], eng.step_count)


def _write_everywhere(eng, reqs, path):
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


@pytest.fixture(scope="module", params=list(XFAMILIES), ids=list(XFAMILIES))
def family(request, tmp_path_factory):
    """Per family: the pair, the requests, each pool's JAX run summary, and
    the JAX paged-fp writer's snapshots (one every tick)."""
    jmodel, jparams, model, master = pair(XFAMILIES[request.param])
    reqs = _jax_requests(model.cfg)
    runs, path = {}, tmp_path_factory.mktemp(request.param)
    for pool in POOLS:
        eng = JaxEngine(jmodel, jparams, cfg=JaxServeConfig(), **_kw(reqs, pool))
        if pool == "paged_fp":  # the snapshot writer too
            snaps = (path, *_write_everywhere(eng, reqs, path))
            runs[pool] = (eng, summary(eng, eng.completions))
        else:
            runs[pool] = (eng, summary(eng, eng.run(reqs)))
    return {"pair": (jmodel, jparams, model, master), "reqs": reqs, "runs": runs,
            "snaps": snaps, "writer": runs["paged_fp"][0]}


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)}
    key = "frames" if cfg.family == "encdec" else "patches"
    batch[key] = np.stack([_extras(cfg, seed + 1 + i)[key] for i in range(b)])
    return batch


def test_gates_are_nonzero(family):
    jmodel, jparams, model, master = family["pair"]
    if model.cfg.family == "vlm":
        assert bool((master["xattn_layers"]["gate"] != 0).all())
        assert bool((np.asarray(jparams["xattn_layers"]["gate"]) != 0).all())


def test_forward_and_cross_leaves_match_jax(family):
    jmodel, jparams, model, master = family["pair"]
    cfg = model.cfg
    params = model.prepare(master, "cpu")
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.forward(params, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)
    _, jcache = jax.jit(jmodel.prefill, static_argnums=2)(jparams, jbatch, 16)
    _, cache = model.prefill(params, tbatch, 16)
    if cfg.family == "encdec":
        jkv = jax.jit(jmodel.encode_cross_kv)(jparams, jbatch["frames"])
        kv = model.encode_cross_kv(params, torch.from_numpy(batch["frames"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(cache[f"cross_{key}"].numpy(),
                                       np.asarray(jcache["cross"][key]), atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(cache["patches"].numpy(), np.asarray(jcache["patches"]))
        assert not model.extra_leaves.keys() & model._per_layer(cache, 0).keys()


def test_static_generate_equals_jax(family):
    jmodel, jparams, model, master = family["pair"]
    params = model.prepare(master, "cpu")
    batch = _batch(model.cfg, seed=5)
    want = jax_engine_mod.generate(jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                   jax_engine_mod.ServeConfig(max_new_tokens=5))
    got = engine.generate(model, params, batch, ServeConfig(max_new_tokens=5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pool", list(POOLS))
def test_engine_equals_jax_and_the_static_oracle(family, pool):
    _, _, model, master = family["pair"]
    reqs = family["reqs"]
    eng = ContinuousEngine(model, master, cfg=ServeConfig(), device="cpu", **_kw(reqs, pool))
    mine = run(eng, to_port(reqs))
    assert_same(mine, family["runs"][pool][1])
    assert eng.paged == (pool != "slab") and set(eng.pool.caches[0]) >= set(
        model.extra_leaves if pool == "slab" else ())
    oracle = engine.static_reference(model, eng.params, to_port(reqs), ServeConfig())
    assert {r.id: np.asarray(oracle[r.id])[len(r.tokens):].tolist() for r in reqs} == mine["tokens"]
    if pool != "slab":  # the extras count in the paged pool's bytes
        extra = sum(t.numel() * t.element_size() for t in eng.pool.extras_shards[0].values())
        assert extra > 0 and eng.pool.hbm_bytes() > extra


def test_jax_snapshot_restores_into_the_port_and_back(family, tmp_path):
    _, _, model, master = family["pair"]
    reqs = family["reqs"]
    path, want, steps = family["snaps"]
    port = ContinuousEngine(model, master, cfg=ServeConfig(), device="cpu",
                            **_kw(reqs, "paged_fp"))
    for step in (steps[1], steps[len(steps) // 2]):
        assert _drain_from(port, path, step) == want, f"diverged from tick {step}"
    port.reset()
    mine, msteps = _write_everywhere(port, to_port(reqs), tmp_path)
    assert mine == want
    writer = family["writer"]
    for step in (msteps[1], msteps[len(msteps) // 2]):
        assert _drain_from(writer, tmp_path, step) == want, f"diverged from tick {step}"
    flat, manifest = store.restore_flat(tmp_path, msteps[1])
    key = "frames" if model.cfg.family == "encdec" else "patches"
    rid = next(iter(manifest["extra"]["requests"]))
    assert manifest["extra"]["requests"][rid]["extras_keys"] == [key]
    np.testing.assert_array_equal(flat[f"req/{rid}/extras/{key}"].numpy(),
                                  reqs[int(rid)].extras[key])
    leaf = "cache/cross/k" if key == "frames" else "cache/patches"
    assert flat[leaf].shape[1 if key == "frames" else 0] == 2


def test_slab_snapshot_with_extras_resumes_identically(family, tmp_path):
    _, _, model, master = family["pair"]
    reqs = family["reqs"]

    def fresh():
        return ContinuousEngine(model, master, cfg=ServeConfig(), device="cpu",
                                **_kw(reqs, "slab"))

    want, steps = _write_everywhere(fresh(), to_port(reqs), tmp_path)
    assert {rid: list(toks) for rid, toks, *_ in want[0]} == family["runs"]["slab"][1]["tokens"]
    restorer = fresh()
    for step in (steps[1], steps[len(steps) // 2], steps[-2]):
        assert _drain_from(restorer, tmp_path, step) == want, f"diverged from tick {step}"
