"""The port's slab pool on the CPU against the JAX package's
(``ContinuousEngine(paged=False)`` over ``SlotKVPool``): reduced f32
internlm2-1.8b (dense), minicpm3-4b (MLA latent slabs) and
llama4-scout-17b-a16e (MoE: a slot's lanes route as a group of their own,
as under the reference's vmap), weights converted from the JAX ones.

  * greedy tokens, ``event_log``, completions and the ``metrics()`` keys the
    two engines share equal the JAX slab engine's; ``read_path`` is
    ``"slab"`` and ``kv_hbm_bytes`` the reference's;
  * spill and recompute preemption on the slab (the reference's
    ``test_preempt_resume_identity_slab``) equal the JAX engine's, and the
    served tokens its static oracle's;
  * the pool: FIFO slot order restored by ``reset``, a slot's row copied in
    and out bitwise;
  * the reference's refusals of the slab options, and ``devices != 1``;
  * ``Model.prefill_chunk`` streaming a prompt as the reference's.
"""
import numpy as np
import pytest
import torch

from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import static_reference as jax_static_reference
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.kv_cache import SlotKVPool

from _torch_parity import (FAMILIES, assert_same, jax_engine, pair, port_engine, prompt, run,
                           set_policy, to_port)

LENS = (5, 9, 14, 22, 7)


def _mixed(vocab, max_new=4):
    return [JaxRequest(id=i, tokens=prompt(vocab, n, 300 + i), max_new_tokens=max_new,
                       arrival_step=i) for i, n in enumerate(LENS)]


def _preempt_reqs(vocab):
    """Two long batch requests fill both slots at step 0; an interactive
    one arrives mid-decode with no slot free (tests/test_torch_sla.py)."""
    batch = [JaxRequest(id=i, tokens=prompt(vocab, 9 + i, 400 + i), max_new_tokens=10,
                        arrival_step=0, req_class="batch") for i in range(2)]
    return batch + [JaxRequest(id=2, tokens=prompt(vocab, 6, 410), max_new_tokens=4,
                               arrival_step=8, req_class="interactive")]


SLAB = {"num_slots": 2, "max_seq": 32, "paged": False}


@pytest.fixture(scope="module")
def runs():
    """The JAX slab engine's run of the mixed workload per family, and of
    the preemption workload under spill and recompute (one engine, its
    policy set between runs), with the static oracle's tokens."""
    out = {}
    for family, arch in FAMILIES.items():
        jmodel, jparams, _, _ = pair(arch)
        eng = jax_engine(jmodel, jparams, sentinels=False, **SLAB)
        out[family] = run(eng, _mixed(jmodel.cfg.vocab))
    jmodel, jparams, _, _ = pair(FAMILIES["dense"])
    reqs = _preempt_reqs(jmodel.cfg.vocab)
    eng = jax_engine(jmodel, jparams, sched="priority", preempt="spill", sentinels=False, **SLAB)
    for mode in ("spill", "recompute"):
        out[mode] = run(set_policy(eng, preempt_mode=mode), reqs)
    ref = jax_static_reference(jmodel, jparams, reqs, JaxServeConfig())
    out["oracle"] = {i: np.asarray(t).tolist() for i, t in ref.items()}
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_slab_engine_equals_jax_slab_engine(runs, family):
    _, _, model, master = pair(FAMILIES[family])
    eng = port_engine(model, master, **SLAB)
    got = run(eng, to_port(_mixed(model.cfg.vocab)))
    assert_same(got, runs[family])
    m = got["metrics"]
    assert m["read_path"] == "slab" and not m["kv_paged"] and not m["sentinels"]
    assert m["kv_hbm_bytes"] == runs[family]["metrics"]["kv_hbm_bytes"]
    assert all(c["finish_reason"] == "length" for c in got["completions"].values())
    # drained, and a reset replay gives the same run
    assert eng.pool.num_free == eng.num_slots
    eng.reset()
    assert run(eng, to_port(_mixed(model.cfg.vocab)))["tokens"] == runs[family]["tokens"]


@pytest.mark.parametrize("mode", ["spill", "recompute"])
def test_preempt_resume_identity_slab(runs, mode):
    _, _, model, master = pair(FAMILIES["dense"])
    reqs = _preempt_reqs(model.cfg.vocab)
    eng = port_engine(model, master, sched="priority", preempt=mode, **SLAB)
    got = run(eng, to_port(reqs))
    assert_same(got, runs[mode])
    assert got["metrics"]["preemptions"] >= 1
    for r in reqs:
        assert list(r.tokens) + got["tokens"][r.id] == runs["oracle"][r.id]


def test_slot_pool_order_and_rows():
    _, _, model, _ = pair(FAMILIES["dense"])
    pool = SlotKVPool(model, num_slots=3, max_seq=8, device="cpu")
    assert pool.hbm_bytes() == sum(t.numel() * t.element_size() for t in pool.caches[0].values())
    assert [pool.allocate() for _ in range(3)] == [0, 1, 2] and pool.num_free == 0
    with pytest.raises(RuntimeError):
        pool.allocate()
    pool.free(1)
    pool.free(0)
    assert pool.allocate() == 1  # FIFO
    row = {k: torch.randn(v[:, :1].shape) for k, v in pool.caches[0].items()}
    addrs = [v.data_ptr() for v in pool.caches[0].values()]
    pool.insert(row, 1, position=5)
    assert pool.positions[1] == 5
    out = pool.extract(1)
    assert all(torch.equal(out[k], row[k]) for k in row)
    assert [v.data_ptr() for v in pool.caches[0].values()] == addrs  # written in place
    pool.advance({1: 3})
    with pytest.raises(ValueError, match="exceeds max_seq"):
        pool.advance({1: 1})
    pool.reset()
    assert [pool.allocate() for _ in range(3)] == [0, 1, 2] and not pool.positions.any()


@pytest.mark.parametrize("kw,err", [
    ({"paged": True, "arch": "mixtral-8x22b"}, "no pageable KV"),
    ({"kv_dtype": "int8"}, "fp-only"),
    ({"prefix_cache": True}, "prefix_cache"),
    ({"block_size": 4}, "block_size/num_blocks"),
    ({"num_blocks": 8}, "block_size/num_blocks"),
    ({"sentinels": True}, "sentinels"),
    ({"chunk": 9, "arch": "mixtral-8x22b"}, "ring capacity"),
])
def test_slab_refusals_as_the_reference(kw, err):
    arch = kw.pop("arch", FAMILIES["dense"])
    _, _, model, master = pair(arch)
    kw = {"paged": False, **kw}
    with pytest.raises(ValueError, match=err):
        ContinuousEngine(model, master, num_slots=2, max_seq=32, cfg=ServeConfig(),
                         device="cpu", **kw)


def test_windowed_model_picks_the_slab_and_devices_stay_refused():
    _, _, model, master = pair("mixtral-8x22b")
    eng = ContinuousEngine(model, master, num_slots=2, max_seq=32, chunk=4, device="cpu")
    assert not eng.paged and eng.metrics()["read_path"] == "slab" and not eng.sentinels
    assert eng.pool.caches[0]["k"].shape[2] == model.cfg.sliding_window  # the ring
    with pytest.raises(NotImplementedError):
        ContinuousEngine(model, master, num_slots=2, max_seq=32, chunk=4, device="cpu",
                         devices=2)


def test_prefill_chunk_streams_a_prompt_as_the_reference():
    """``Model.prefill_chunk`` over a batch at one position: a prompt
    streamed chunk by chunk (the last one ragged) gives the JAX model's
    logits within 1e-5 (reduced mixtral: the ring wraps), and the
    ``last_only`` row is row n_valid - 1 of the full projection."""
    import jax.numpy as jnp

    jmodel, jparams, model, master = pair("mixtral-8x22b")
    params = model.prepare(master, "cpu")
    toks = np.stack([prompt(256, 19, 950 + i) for i in range(2)])
    jcache, cache = jmodel.init_cache(2, 24), model.init_cache(2, 24, "cpu")
    for pos in range(0, 19, 4):
        n = min(4, 19 - pos)
        chunk = np.zeros((2, 4), np.int32)
        chunk[:, :n] = toks[:, pos:pos + n]
        want, jcache = jmodel.prefill_chunk(jparams, jcache, jnp.asarray(chunk), pos, n)
        with torch.no_grad():
            full, _ = model.prefill_chunk(params, {k: v.clone() for k, v in cache.items()},
                                          torch.as_tensor(chunk), pos, n)
            got, cache = model.prefill_chunk(params, cache, torch.as_tensor(chunk), pos, n,
                                             last_only=True)
        np.testing.assert_allclose(full[:, :n].numpy(), np.asarray(want)[:, :n], atol=1e-5,
                                   rtol=0)
        assert torch.equal(got[:, 0], full[:, n - 1])
