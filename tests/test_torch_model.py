"""The port's dense model against the JAX package: configs field for field,
the parameter converter, RoPE and the paged write indices, and the logits of
one fused paged tick (mixed prefill / decode / parked lanes) from the same
weights and the same arena contents."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import attention as jax_attn
from repro.models.rope import apply_rope as jax_rope
from repro.models.transformer import make_model as jax_make_model
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import make_model

BS, NB, C = 4, 12, 4
# one fused tick: slot 0 prefills 4 tokens from 0, slot 1 decodes at 9,
# slot 2 prefills 3 tokens at 5, slot 3 is parked (its logits are don't-care)
POSITIONS = np.array([0, 9, 5, 0], np.int32)
N_VALID = np.array([4, 1, 3, 0], np.int32)
LIVE = N_VALID > 0


@pytest.mark.parametrize("name", registry.list_archs())
def test_configs_copied_field_for_field(name):
    mine, ref = registry.get_config(name), jax_registry.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(registry.reduce_config(mine))
            == dataclasses.asdict(jax_registry.reduce_config(ref)))


def _pair(dtype="float32", **over):
    jcfg = jax_registry.reduce_config(jax_registry.get_config("internlm2-1.8b"),
                                      dtype=dtype, **over)
    tcfg = registry.reduce_config(registry.get_config("internlm2-1.8b"), dtype=dtype, **over)
    jmodel, tmodel = jax_make_model(jcfg), make_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tmodel, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, tmodel, tparams


def test_converter_checks_keys_and_shapes():
    _, _, jparams, tmodel, tparams = _pair()
    np.testing.assert_array_equal(tparams["layers"]["mixer"]["wq"].numpy(),
                                  np.asarray(jparams["layers"]["mixer"]["wq"]))
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"]["mlp"]["wg"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tmodel, tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"]["w"] = tree["lm_head"]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tmodel, tree, device="cpu")


def test_port_init_matches_reference_structure():
    _, _, jparams, tmodel, _ = _pair()
    tp = tmodel.init(seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)

    def walk(t, s):
        if isinstance(t, dict):
            assert set(t) == set(s)
            for k in t:
                walk(t[k], s[k])
        else:
            assert tuple(t.shape) == s and t.dtype == torch.float32

    walk(tp, shapes)
    assert torch.equal(tp["final_norm"]["gamma"], torch.ones(tmodel.cfg.d_model))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = (np.arange(5)[None] + np.array([[0], [37]])).astype(np.int32)
    mine = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos), 1e6)
    ref = jax_rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-6 if dtype == "float32" else 2 ** -7, rtol=0)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    from repro.models.layers import apply_mlp as jax_mlp
    from repro_torch.models.layers import apply_mlp

    cfg = registry.reduce_config(registry.get_config("internlm2-1.8b"), mlp_act=act,
                                 dtype="float32")
    rng = np.random.default_rng(2)
    p = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
         for k, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))
         if act == "swiglu" or k != "wg"}
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    mine = apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    ref = jax_mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_paged_write_indices_match_reference():
    rows = POSITIONS[:, None] + np.arange(C)[None]
    tables = np.arange(16, dtype=np.int32).reshape(4, 4)
    mine = t_attn.paged_write_indices(torch.from_numpy(rows), torch.from_numpy(N_VALID),
                                      torch.from_numpy(tables), BS, NB).numpy()
    ref = np.asarray(jax_attn.paged_write_indices(jnp.asarray(rows), jnp.asarray(N_VALID),
                                                  jnp.asarray(tables), BS, NB))
    np.testing.assert_array_equal(mine, ref)


def _tick(jcfg, jmodel, jparams, tmodel, tparams):
    """The same fused tick through both packages; returns their logits and
    arenas (the port's without its sink block)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, size=(4, C)).astype(np.int32)
    tables = rng.permutation(NB)[:12].reshape(4, 3).astype(np.int32)
    kv_shape = (jcfg.n_layers, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.normal(size=kv_shape).astype(np.float32)  # prior context
    v0 = rng.normal(size=kv_shape).astype(np.float32)
    jcache = jmodel.init_paged_cache(4, NB, BS, 16)
    dt = jcache["layers"]["k"].dtype
    jcache["layers"] = {"k": jnp.asarray(k0).astype(dt), "v": jnp.asarray(v0).astype(dt)}
    jlogits, jnew = jmodel.fused_step_slots_paged(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(POSITIONS),
        jnp.asarray(N_VALID), jnp.asarray(tables))
    tcache = tmodel.init_paged_cache(NB, BS, "cpu")
    tcache["k"][:, :NB] = torch.from_numpy(k0)
    tcache["v"][:, :NB] = torch.from_numpy(v0)
    tlogits = tmodel.fused_step_slots_paged(
        tmodel.prepare(tparams, "cpu"), tcache,
        *(torch.from_numpy(a) for a in (tokens, POSITIONS, N_VALID, tables)))
    return (tlogits.float().numpy(), np.asarray(jlogits.astype(jnp.float32)),
            {k: tcache[k][:, :NB].float().numpy() for k in ("k", "v")},
            {k: np.asarray(jnew["layers"][k].astype(jnp.float32)) for k in ("k", "v")})


@pytest.mark.parametrize("n_kv_heads", [4, 2])  # the reduced config's MHA, and GQA group 2
def test_fused_tick_logits_match_reference_f32(n_kv_heads):
    tl, jl, ta, ja = _tick(*_pair("float32", n_kv_heads=n_kv_heads))
    np.testing.assert_allclose(tl[LIVE], jl[LIVE], atol=1e-5, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(ta[k], ja[k], atol=1e-6, rtol=0)


def test_fused_tick_logits_match_reference_bf16():
    """bf16 rounds at other places (the reference rounds its scores and
    probabilities to bf16, the port's read keeps them f32): logits within
    0.02 at |logit| <~ 0.5; the first layer writes identical K/V, the second
    its K/V from inputs one bf16 rounding apart."""
    tl, jl, ta, ja = _tick(*_pair("bfloat16"))
    np.testing.assert_allclose(tl[LIVE], jl[LIVE], atol=2e-2, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(ta[k][0], ja[k][0])
        np.testing.assert_allclose(ta[k][1:], ja[k][1:], atol=8e-3, rtol=2 ** -7)
