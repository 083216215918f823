"""Prompts past 2048 tokens on the CPU: the port's static path (GN flash
attention past ``CHUNKED_FROM``) and its continuous engine against the JAX
package, reduced internlm2-1.8b with GQA (4 q / 2 kv heads) at float32,
weights through ``convert.py``.

Past 2048 tokens the reference's ``attn_prefill`` and ``forward`` take
``chunked_self_attention``, whose causal hierarchy of halves serves only
lengths 2048 * 2^k: at 3072 its kv scan asserts (``chunked_attention.py:100``,
a kv length of 1536 against a chunk of 1024), as at 2560, and at 2049 a
reshape fails.  So the port is held to the chunked path at 4096
and, at 3072 and 2049, to the reference's one-pass GN attention (its
``_use_chunked`` patched off for the test), the function the reference's own
tests hold the chunked path to within 5e-3 (``tests/test_chunked_attention.py``).
On the CPU the port's flash route runs the kernel's plain one-pass version.
Tolerances: attention outputs 5e-3, the reference's chunked-versus-one-pass
GN tolerance; logits 2e-4, the port's static tests' tolerance against an
online GN accumulation (the Pallas kernel in interpret mode); greedy tokens
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models import attention as jax_attn
from repro.models.transformer import make_model as jax_make_model
from repro.serve import engine as jax_engine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.launch import serve as serve_launch
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import make_model
from repro_torch.serve import engine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq

ARCH = "internlm2-1.8b"
ATTN_ATOL = 5e-3
LOGITS_ATOL = 2e-4
CHUNKED = 4096  # the shortest length past 2048 the reference's chunked path serves


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, the port's prepared params, its
    f32 masters)."""
    over = {"dtype": "float32", "n_kv_heads": 2}
    jmodel = jax_make_model(jax_reduce_config(jax_get_config(ARCH), **over))
    tmodel = make_model(reduce_config(get_config(ARCH), **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    master = params_from_numpy(tmodel, jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tmodel, tmodel.prepare(master, "cpu"), master


def _one_pass_reference(monkeypatch, s: int) -> None:
    """Below 4096 the reference runs its one-pass GN attention (see the
    module docstring)."""
    if s != CHUNKED:
        monkeypatch.setattr(jax_attn, "_use_chunked", lambda cfg, s: False)


def _tokens(b, s, seed):
    return batch_at(DataConfig(vocab=256, seq_len=s, global_batch=b, seed=seed), 0)["tokens"]


@pytest.mark.parametrize("s", [3072, CHUNKED])
def test_attn_prefill_past_2048_matches_jax(pair, monkeypatch, s):
    jmodel, jparams, tmodel, tparams, _ = pair
    _one_pass_reference(monkeypatch, s)
    cfg = tmodel.cfg
    x = np.random.default_rng(s).normal(size=(1, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    mixer = jax.tree.map(lambda a: a[0], jparams["layers"])["mixer"]
    want, jkv = jax_attn.attn_prefill(jmodel.cfg, mixer, jnp.asarray(x), jnp.asarray(pos))
    got, kv = t_attn.attn_prefill(cfg, tparams["layers"][0]["mixer"], torch.from_numpy(x),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)
    for key in ("k", "v"):
        assert kv[key].shape == (1, s, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key]), atol=1e-6, rtol=0)


def test_forward_past_2048_matches_jax_chunked(pair):
    jmodel, jparams, tmodel, tparams, _ = pair
    toks = _tokens(1, CHUNKED, seed=4)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("s", [3072, CHUNKED])
def test_generate_past_2048_tokens_equal_jax(pair, monkeypatch, s):
    jmodel, jparams, tmodel, tparams, _ = pair
    _one_pass_reference(monkeypatch, s)
    toks = _tokens(1, s, seed=5)
    want = jax_engine.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                               jax_engine.ServeConfig(max_new_tokens=4))
    got = engine.generate(tmodel, tparams, {"tokens": torch.from_numpy(toks)},
                          engine.ServeConfig(max_new_tokens=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_engine_past_2048_equals_both_static_oracles(pair, monkeypatch):
    """Prompts of 2049 and 3072 tokens through the continuous engine (chunk
    256, block 64, 2 slots): greedy tokens equal to the port's
    ``static_reference``, the JAX engine's and the JAX ``static_reference``'s
    (one-pass, see the module docstring)."""
    jmodel, jparams, tmodel, tparams, master = pair
    _one_pass_reference(monkeypatch, 3072)
    lens = (2049, 3072)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in lens]

    def reqs(cls):
        return [cls(id=i, tokens=p, max_new_tokens=4, arrival_step=i)
                for i, p in enumerate(prompts)]

    kw = {"num_slots": 2, "max_seq": required_max_seq(reqs(Request)), "chunk": 256,
          "block_size": 64}
    eng = engine.ContinuousEngine(tmodel, master, device="cpu", **kw)
    got = {c.request_id: c.tokens for c in eng.run(reqs(Request))}
    assert eng.pool.blocks_in_use == 0 and eng.metrics()["read_path"] == "kernel"
    oracles = {
        "port static": engine.static_reference(tmodel, eng.params, reqs(Request),
                                                engine.ServeConfig()),
        "jax engine": {c.request_id: c.tokens for c in jax_engine.ContinuousEngine(
            jmodel, jparams, sentinels=False, **kw).run(reqs(JaxRequest))},
        "jax static": jax_engine.static_reference(jmodel, jparams, reqs(JaxRequest),
                                                  jax_engine.ServeConfig()),
    }
    for name, oracle in oracles.items():
        for rid, toks in got.items():
            np.testing.assert_array_equal(toks, np.asarray(oracle[rid]), err_msg=f"{name} {rid}")


def test_prefill_routes_2048_one_pass_and_2049_flash(pair, monkeypatch):
    """s <= 2048 takes the one-pass route (the softmax kernel's fused score
    entry over the score rows) and s > 2048 the flash-attention kernel,
    causal, as the reference routes to ``chunked_self_attention``."""
    _, _, tmodel, tparams, _ = pair
    calls = []
    for name in ("gn_softmax_scores", "gn_attention"):
        kernel = getattr(t_attn, name)
        monkeypatch.setattr(t_attn, name, lambda *a, _k=kernel, _n=name, **kw:
                            calls.append((_n, kw.get("causal"))) or _k(*a, **kw))
    for s, want in ((2048, ("gn_softmax_scores", None)), (2049, ("gn_attention", True))):
        calls.clear()
        logits, cache = tmodel.prefill(tparams, {"tokens": torch.zeros(1, s, dtype=torch.int32)})
        assert calls == [want] * tmodel.cfg.n_layers
        assert logits.shape == (1, s, tmodel.cfg.vocab) and cache["k"].shape[2] == s


def test_launcher_static_mode_serves_prompts_past_2048(capsys):
    out = serve_launch.main(["--smoke", "--device", "cpu", "--dtype", "float32",
                             "--batches", "1", "--batch-size", "1", "--prompt-len", "2049",
                             "--new-tokens", "2"])
    assert out["outputs"][0].shape == (1, 2051)
    assert np.isfinite(out["perplexities"][0])
    assert "batch 0: (1, 2051)" in capsys.readouterr().out
