"""The port's static path on the CPU against the JAX package: the logits of
``forward``, ``prefill`` and ``decode_step``, greedy ``generate``,
``static_reference`` with stop-token truncation and ``perplexity``; the
synthetic corpus; the port's continuous engine against its own static
oracle; and the launcher's static and continuous modes.  Reduced
internlm2-1.8b (4 q / 4 kv heads), a GQA variant (4 q / 2 kv heads), and
reduced stablelm-1.6b (gn_ln) and gpt-neo-1.3b (gn_ln, gelu; Table I's
backbone); the same weights through ``convert.py`` and the same numpy
tokens on both sides.  On the CPU both attention kernels run their plain one-pass
versions, so the port and the JAX one-pass path agree to float association
(1e-5 on logits of |logit| < 1 at f32), and to the online corrections'
Q1.15 rounding against the Pallas kernel in interpret mode (2e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import synthetic as jax_synth
from repro.models.transformer import make_model as jax_make_model
from repro.serve import engine as jax_engine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.data import synthetic
from repro_torch.kernels import counters
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import make_model
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq

ARCH = "internlm2-1.8b"
LOGITS_ATOL = 1e-5


@pytest.fixture(scope="module", params=[(ARCH, 4), (ARCH, 2), ("stablelm-1.6b", None),
                                        ("gpt-neo-1.3b", None)],
                ids=["mha", "gqa2", "stablelm", "gptneo"])
def pair(request):
    """(JAX model, JAX params, port model, the port's prepared params, its
    f32 masters) from the same weights, float32, for the fixture's arch
    (internlm2-1.8b at n_kv_heads 4 and 2)."""
    arch, kv = request.param
    over = {"dtype": "float32", **({"n_kv_heads": kv} if kv else {})}
    jmodel = jax_make_model(jax_registry.reduce_config(jax_registry.get_config(arch), **over))
    tmodel = make_model(registry.reduce_config(registry.get_config(arch), **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tmodel, jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tmodel, tmodel.prepare(tparams, "cpu"), tparams


def _tokens(b, s, seed, vocab=256):
    cfg = synthetic.DataConfig(vocab=vocab, seq_len=s, global_batch=b, seed=seed)
    return synthetic.batch_at(cfg, 0)["tokens"]


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def test_forward_logits_match_jax_f32(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    toks = _tokens(2, 24, seed=1)
    jl, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == jl.shape
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)


def test_forward_matches_jax_pallas_kernel_interpret(pair):
    """The reference's use_pallas forward runs its online flash kernel in
    interpret mode; the port's CPU forward, the one-pass plain version."""
    jmodel, jparams, tmodel, tparams, _ = pair
    jmodel = jax_make_model(dataclasses.replace(jmodel.cfg, use_pallas=True))
    toks = _tokens(2, 20, seed=2)
    jl, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=2e-4, rtol=0)


def test_prefill_and_decode_logits_match_jax_f32(pair):
    """Prefill logits and slab cache, then three decode steps fed the JAX
    run's greedy tokens, logits and the cache slots they write."""
    jmodel, jparams, tmodel, tparams, _ = pair
    toks = _tokens(3, 12, seed=3)
    s, steps = toks.shape[1], 3
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, s + steps)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, s + steps)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    assert tcache["k"].shape == jcache["layers"]["k"].shape
    for i in range(steps):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.int32(s + i))
        tl, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(nxt), s + i)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache["layers"][k]), atol=1e-6, rtol=0)


def test_generate_tokens_identical_to_jax_f32(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    toks = _tokens(3, 10, seed=4)
    want = jax_engine.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                               jax_engine.ServeConfig(max_new_tokens=8))
    got = engine.generate(tmodel, tparams, {"tokens": toks}, engine.ServeConfig(max_new_tokens=8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_static_reference_identical_to_jax_with_stop_tokens(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    specs = [(5, 4), (9, 6), (9, 6), (14, 4), (5, 4)]  # (prompt_len, max_new): 3 groups
    prompts = [_tokens(1, n, seed=50 + i)[0] for i, (n, _) in enumerate(specs)]

    def run(stops):
        mine = engine.static_reference(
            tmodel, tparams, [Request(id=i, tokens=p, max_new_tokens=m, stop_token=stops[i])
                              for i, (p, (_, m)) in enumerate(zip(prompts, specs))],
            engine.ServeConfig())
        ref = jax_engine.static_reference(
            jmodel, jparams, [JaxRequest(id=i, tokens=p, max_new_tokens=m, stop_token=stops[i])
                              for i, (p, (_, m)) in enumerate(zip(prompts, specs))],
            jax_engine.ServeConfig())
        assert sorted(mine) == sorted(ref)
        for i in ref:
            np.testing.assert_array_equal(mine[i], np.asarray(ref[i]))
        return mine

    full = run([None] * len(specs))
    # stop at request 1's second new token and request 3's first; request 4's
    # stop token never appears
    stops = [None, int(full[1][9 + 1]), None, int(full[3][14]), -1]
    cut = run(stops)
    assert len(cut[1]) <= 9 + 2 and len(cut[3]) == 14 + 1 and len(cut[4]) == len(full[4])


def test_perplexity_matches_jax(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    toks = _tokens(2, 20, seed=5)
    want = jax_engine.perplexity(jmodel, jparams, {"tokens": jnp.asarray(toks)})
    got = engine.perplexity(tmodel, tparams, {"tokens": toks})
    assert abs(got - want) <= 1e-4 * want


def test_sampling_is_refused(pair):
    """``generate`` samples now (tests/test_torch_sampling.py); the static
    oracle is greedy only and refuses a sampled request or config."""
    _, _, tmodel, tparams, _ = pair
    out = engine.generate(tmodel, tparams, {"tokens": _tokens(1, 4, 6)},
                          engine.ServeConfig(max_new_tokens=2, temperature=0.7))
    assert tuple(out.shape) == (1, 6)
    with pytest.raises(ValueError):
        engine.static_reference(tmodel, tparams, [Request(id=0, tokens=np.arange(4),
                                                          temperature=0.7)], engine.ServeConfig())
    with pytest.raises(ValueError):
        engine.static_reference(tmodel, tparams, [Request(id=0, tokens=np.arange(4))],
                                engine.ServeConfig(temperature=0.7))


@pytest.mark.parametrize("bs", [4, 8])
def test_continuous_engine_matches_own_static_reference(pair, bs):
    """Mixed prompt lengths through 2 slots (queueing and slot reuse), chunk
    4: the engine's greedy tokens equal the port's static oracle."""
    _, _, tmodel, _, masters = pair
    reqs = [Request(id=i, tokens=_tokens(1, n, seed=300 + i)[0], max_new_tokens=5,
                    arrival_step=i) for i, n in enumerate([5, 9, 14, 22, 7])]
    eng = engine.ContinuousEngine(tmodel, masters, num_slots=2, max_seq=required_max_seq(reqs),
                                  chunk=4, block_size=bs, device="cpu")
    comps = eng.run(reqs)
    ref = engine.static_reference(tmodel, eng.params, reqs, engine.ServeConfig())
    assert len(comps) == len(reqs)
    for c in comps:
        np.testing.assert_array_equal(c.tokens, ref[c.request_id])


def test_refuses_long_prefill_and_other_softmax():
    """A prefill past 2048 tokens takes the GN flash attention (its plain
    version on the CPU) and is served; the exact softmax serves the forward
    (tests/test_torch_train.py holds it against the JAX package) and its
    long prefill through the chunked stream, as the reference
    (tests/test_torch_chunked.py holds it against the JAX package); a
    one-pass-only softmax (a baseline, as ``pseudo``) serves the long
    prefill one-pass, as the reference's ``_use_chunked`` keeps it; a name
    neither package has raises ``KeyError`` (tests/test_torch_long.py holds
    the long path against the JAX package)."""
    cfg = registry.reduce_config(registry.get_config(ARCH), dtype="float32")
    model = make_model(cfg)
    params = model.prepare(model.init(0, "cpu"), "cpu")
    long = {"tokens": torch.zeros(1, 2049, dtype=torch.int32)}
    logits, _ = model.prefill(params, long)
    assert logits.shape == (1, 2049, cfg.vocab) and bool(torch.isfinite(logits).all())
    exact = make_model(dataclasses.replace(cfg, softmax_impl="exact"))
    logits, _ = exact.prefill(params, long)
    assert logits.shape == (1, 2049, cfg.vocab) and bool(torch.isfinite(logits).all())
    short = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    assert bool(torch.isfinite(exact.forward(params, short)).all())
    other = make_model(dataclasses.replace(cfg, softmax_impl="pseudo"))
    logits, _ = other.prefill(params, long)
    assert logits.shape == (1, 2049, cfg.vocab) and bool(torch.isfinite(logits).all())
    with pytest.raises(KeyError, match="nope"):
        make_model(dataclasses.replace(cfg, softmax_impl="nope")).forward(params, short)


# ------------------------------------------------------- synthetic corpus --
def test_batch_at_follows_the_successor_chain_and_is_deterministic():
    cfg = synthetic.DataConfig(vocab=97, seq_len=30, global_batch=5, seed=3)
    jcfg = jax_synth.DataConfig(vocab=97, seq_len=30, global_batch=5, seed=3)
    toks = synthetic.batch_at(cfg, 2)["tokens"]
    assert toks.shape == (5, 30) and toks.dtype == np.int32
    assert (toks >= 0).all() and (toks < cfg.vocab).all()
    np.testing.assert_array_equal(toks, synthetic.batch_at(cfg, 2)["tokens"])
    assert not np.array_equal(toks, synthetic.batch_at(cfg, 3)["tokens"])
    ks = np.arange(cfg.branching)
    for t in range(cfg.seq_len - 1):
        succ = np.asarray(jax_synth._successor(jcfg, toks[:, t, None].astype(np.int32), ks))
        assert (succ == toks[:, t + 1, None]).any(axis=1).all()


@pytest.mark.parametrize("kw", [{}, {"branching": 4, "zipf_a": 1.1}])
def test_zipf_and_optimal_perplexity_match_jax(kw):
    mine, ref = synthetic.DataConfig(**kw), jax_synth.DataConfig(**kw)
    np.testing.assert_array_equal(synthetic.zipf_probs(mine), jax_synth.zipf_probs(ref))
    assert synthetic.optimal_perplexity(mine) == jax_synth.optimal_perplexity(ref)


# --------------------------------------------------------------- launcher --
def test_launch_static_mode_prints_per_batch_perplexity(capsys):
    counters.reset()
    out = serve_launch.main(["--smoke", "--device", "cpu", "--batches", "2", "--batch-size", "2",
                             "--prompt-len", "8", "--new-tokens", "3"])
    text = capsys.readouterr().out
    assert "batch 0: (2, 11) in" in text and "batch 1: (2, 11) in" in text
    assert text.count("seq ppl") == 2 and "served 2 batches" in text
    assert all(np.isfinite(out["perplexities"])) and len(out["outputs"]) == 2
    assert out["launches"] == dict.fromkeys(counters.WRAPPERS, 0)  # plain versions on the CPU


def test_launch_continuous_mode_reports_identity_with_static_path(capsys):
    """Identity at float32; at bf16 the paged read's f32 scores and the
    static path's bf16 scores may part (see launch/serve.py)."""
    out = serve_launch.main(["--smoke", "--continuous", "--device", "cpu", "--dtype", "float32",
                             "--requests", "5", "--num-slots", "2", "--new-tokens", "4",
                             "--max-prompt", "14"])
    text = capsys.readouterr().out
    assert "greedy outputs token-identical to static path: 5/5" in text
    assert out["static_identical"] == 5 and out["common_prefix"] == [4] * 5
