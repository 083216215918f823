"""The port's MLA mixer (``models/mla.py``) and the MLA family
(minicpm3-4b) on the CPU against the JAX package: its ops and its static
path.  Reduced minicpm3-4b at f32 (q/kv latents 32/16, nope 16, rope 8,
v 16), the JAX weights through ``convert.py``, the same numpy inputs.

  * ``_project`` (both GN latent norms) and ``_attend`` with its Σp probe
    within 1e-6;
  * ``mla_paged_chunk`` over fp and int8 latent arenas, through the
    streamed and the gathered read: the output within 1e-6, the arenas after
    the write within 1e-6 (fp) and bitwise (the int8 latents and their
    frozen scales), the
    sentinel word (Σp residual within 1e-6, clip share and scale flag
    exact); the port's streamed read bitwise its gathered read; a forced
    kernel read falls through to the streamed one;
  * ``forward``, ``prefill`` and ``decode_step`` logits within the dense
    tolerance (1e-5) and the latent slabs within 1e-6, ``generate`` and
    ``static_reference`` tokens identical, ``perplexity`` within 1e-6
    relative;
  * ``make_model`` accepts minicpm3-4b and llama4-scout-17b-a16e (full and
    reduced); a MoE MLP under the SSM, hybrid, encdec and VLM families stays
    refused (the registry's xlstm-350m and zamba2-7b build, as do encdec and
    VLM without a MoE MLP; sliding windows build, and an MLA prompt past
    2048 tokens is served); ``prepare`` casts MLA's projections and keeps
    its latent gammas f32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import mla as jax_mla
from repro.serve import engine as jax_engine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.models import attention as t_attn
from repro_torch.models import mla
from repro_torch.models.transformer import Model, make_model
from repro_torch.serve import engine

from _torch_parity import FAMILIES, pair, prompt, to_port

ARCH = FAMILIES["mla"]
ATOL = 1e-6
LOGITS_ATOL = 1e-5


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None
    jax_attn.FORCE_PAGED_READ = None


@pytest.fixture(scope="module")
def mini():
    jmodel, jparams, model, master = pair(ARCH)
    return {"jmodel": jmodel, "jparams": jparams, "model": model, "master": master,
            "prepared": model.prepare(master, "cpu"),
            "jlayer": jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])}


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_project_and_attend_equal_jax(mini):
    cfg, jcfg = mini["model"].cfg, mini["jmodel"].cfg
    p, jp = mini["prepared"]["layers"][0]["mixer"], mini["jlayer"]
    x = _x(2, 10, cfg.d_model, 0)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    want = jax.jit(functools.partial(jax_mla._project, jcfg))(jp, x, pos)
    got = mla._project(cfg, p, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)
    lanes = np.arange(10)[None, :] < np.array([10, 6])[:, None]
    mask = jax_attn.causal_mask(10, 10)
    jout, jprobe = jax.jit(lambda *a: jax_mla._attend(jcfg, *a[:-1], probe_lanes=a[-1]))(
        jp, *want, mask, lanes)
    out, probe = mla._attend(cfg, p, *got, t_attn.causal_mask(10, 10),
                             probe_lanes=torch.from_numpy(lanes))
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
    np.testing.assert_allclose(probe.numpy(), np.asarray(jprobe), atol=ATOL, rtol=0)
    assert float(probe.max()) < 1e-5


def _paged_case(cfg, seed, bs=4, n=3, c=4, max_bt=6):
    """Latent arenas of random values (int8-range ones too), shuffled
    tables with stale entries past each chain, mixed lanes: a prefilling
    slot, a decoding one, a parked one."""
    rng = np.random.default_rng(seed)
    nb = n * max_bt + 2
    m = cfg.mla
    ckv = rng.standard_normal((nb, bs, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((nb, bs, m.qk_rope_head_dim)).astype(np.float32)
    tables = rng.permutation(nb)[:n * max_bt].reshape(n, max_bt).astype(np.int32)
    positions = np.array([8, 13, 0], np.int32)
    n_valid = np.array([c, 1, 0], np.int32)
    x = _x(n, c, cfg.d_model, seed + 1)
    scales = [rng.uniform(0.01, 0.05, nb).astype(np.float32) for _ in range(2)]
    q8 = [rng.integers(-127, 128, a.shape).astype(np.int8) for a in (ckv, krope)]
    return {"ckv": ckv, "krope": krope, "tables": tables, "positions": positions,
            "n_valid": n_valid, "x": x, "scales": scales, "q8": q8}


def _port_arena(a):
    """A JAX arena with the port's write-sink block appended."""
    return torch.from_numpy(np.concatenate([a, np.zeros_like(a[:1])]))


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("path", ["streamed", "gathered"])
def test_paged_chunk_equals_jax(mini, kv_dtype, path):
    cfg, jcfg = mini["model"].cfg, mini["jmodel"].cfg
    p, jp = mini["prepared"]["layers"][0]["mixer"], mini["jlayer"]
    case = _paged_case(cfg, seed=11 + (kv_dtype == "int8"))
    ints = [case[k] for k in ("positions", "n_valid", "tables")]
    jax_attn.FORCE_PAGED_READ = t_attn.FORCE_PAGED_READ = path
    if kv_dtype == "int8":
        arenas, scales = case["q8"], case["scales"]
    else:
        arenas, scales = (case["ckv"], case["krope"]), None
    jout, jarenas, jword = jax_mla.mla_paged_chunk(
        jcfg, jp, *map(jnp.asarray, arenas), jnp.asarray(case["x"]), *map(jnp.asarray, ints),
        scales=None if scales is None else tuple(map(jnp.asarray, scales)), probe=True)
    t_arenas = [_port_arena(a) for a in arenas]
    t_scales = None if scales is None else tuple(
        torch.from_numpy(np.append(s, np.float32(0))) for s in scales)
    out, probe = mla.mla_paged_chunk(cfg, p, *t_arenas, torch.from_numpy(case["x"]),
                                     *map(torch.from_numpy, ints), t_scales, probe=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    live = case["n_valid"] > 0
    word = t_attn.paged_probe_word([probe], *map(torch.from_numpy, ints), 4,
                                   None if t_scales is None else tuple(s[None] for s in t_scales))
    np.testing.assert_allclose(word[0, :, 0].numpy(), np.asarray(jword)[:, 0], atol=ATOL)
    np.testing.assert_array_equal(word[0, :, 1:].numpy(), np.asarray(jword)[:, 1:])
    assert (word[0, ~live] == 0).all() and np.isfinite(word[0].numpy()).all()
    nb = arenas[0].shape[0]
    for got, want in zip(list(t_arenas) + list(t_scales or ()), jarenas):
        if kv_dtype == "int8":  # the quantized latents and their frozen scales
            np.testing.assert_array_equal(got[:nb].numpy(), np.asarray(want))
        else:  # the projections' float association apart
            np.testing.assert_allclose(got[:nb].numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # the streamed and the gathered read of the port: bitwise
    other = "gathered" if path == "streamed" else "streamed"
    t_attn.FORCE_PAGED_READ = other
    again = mla.mla_paged_chunk(cfg, p, *t_arenas, torch.from_numpy(case["x"]),
                                *map(torch.from_numpy, ints), t_scales)
    assert torch.equal(again, out)


def test_forced_kernel_read_falls_through_to_streamed(mini):
    t_attn.FORCE_PAGED_READ = "kernel"
    assert mini["model"].paged_read_path == "streamed"
    gn = dataclasses.replace(mini["model"].cfg, softmax_impl="gn_hwsim")
    t_attn.FORCE_PAGED_READ = None
    assert mla.mla_paged_read_path(gn) == "gathered"


def test_forward_prefill_decode_logits_equal_jax(mini):
    jmodel, jparams, model, params = (mini[k] for k in ("jmodel", "jparams", "model",
                                                        "prepared"))
    toks = np.stack([prompt(model.cfg.vocab, 12, 40 + i) for i in range(3)])
    jl, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    tl = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    s, steps = 12, 3
    jl, jc = jax.jit(jmodel.prefill, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(toks)}, s + steps)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, s + steps)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc["layers"].items()}
    jdecode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jdecode(jparams, jc, jnp.asarray(nxt), jnp.int32(s + i))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(nxt), s + i)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc["layers"][k]), atol=ATOL, rtol=0)


def test_generate_static_reference_perplexity_equal_jax(mini):
    jmodel, jparams, model, params = (mini[k] for k in ("jmodel", "jparams", "model",
                                                        "prepared"))
    toks = np.stack([prompt(model.cfg.vocab, 10, 50 + i) for i in range(3)])
    want = jax_engine.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                               jax_engine.ServeConfig(max_new_tokens=6))
    got = engine.generate(model, params, {"tokens": toks}, engine.ServeConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # generate's batch again: one prompt length, one group on both sides
    reqs = [JaxRequest(id=i, tokens=t, max_new_tokens=6) for i, t in enumerate(toks)]
    ref = jax_engine.static_reference(jmodel, jparams, reqs, jax_engine.ServeConfig())
    mine = engine.static_reference(model, params, to_port(reqs), engine.ServeConfig())
    assert {i: t.tolist() for i, t in mine.items()} == {
        i: np.asarray(t).tolist() for i, t in ref.items()}
    ptoks = np.stack([prompt(model.cfg.vocab, 24, 70 + i) for i in range(2)])
    want_ppl = jax_engine.perplexity(jmodel, jparams, {"tokens": jnp.asarray(ptoks)})
    got_ppl = engine.perplexity(model, params, {"tokens": ptoks})
    assert abs(got_ppl - want_ppl) <= 1e-6 * want_ppl


def test_mla_past_2048_tokens_is_refused(mini):
    """No longer refused: past 2048 tokens MLA streams as the reference's
    ``_attend_chunked`` (the flash kernel over the concatenated head dim,
    its plain version here; tests/test_torch_chunked.py holds it against
    the JAX package); the forward and the prefill agree on the logits."""
    model, params = mini["model"], mini["prepared"]
    toks = torch.zeros(1, 2049, dtype=torch.int32)
    logits = model.forward(params, {"tokens": toks})
    assert logits.shape == (1, 2049, model.cfg.vocab) and bool(torch.isfinite(logits).all())
    torch.testing.assert_close(model.prefill(params, {"tokens": toks})[0], logits)
    assert model.forward(params, {"tokens": toks[:, :2048]}).shape == (1, 2048, model.cfg.vocab)


@pytest.mark.parametrize("arch", [FAMILIES["mla"], FAMILIES["moe"]])
def test_make_model_takes_the_mla_and_moe_configs(arch):
    for cfg in (get_config(arch), reduce_config(get_config(arch))):
        model = make_model(cfg)
        specs = model.param_specs()["layers"]
        assert ("wkv_b" in specs["mixer"]) == (cfg.mla is not None)
        assert ("router" in specs["mlp"]) == (cfg.moe is not None)


@pytest.mark.parametrize("over", [{"family": "ssm"}, {"family": "hybrid"},
                                  {"family": "encdec"}, {"family": "vlm"},
                                  {"sliding_window": 4096}, {"family": "moe", "moe": None}])
def test_other_families_stay_refused(over):
    cfg = dataclasses.replace(get_config(FAMILIES["moe"]), **over)
    if "sliding_window" in over:
        # ported: a sliding window builds, keeps a ring in the slab cache
        # and pages nothing (tests/test_torch_window.py, test_torch_slab.py)
        model = Model(cfg)
        assert not model.supports_paging
        assert model.cache_specs(2, 8192)["k"][0][2] == 4096
        with pytest.raises(ValueError, match="no pageable KV"):
            model.init_paged_cache(4, 16, "cpu")
        return
    if over.get("family") in ("encdec", "vlm"):
        # ported: the encoder-decoder and VLM families (tests/test_torch_xattn.py);
        # a MoE MLP under them has no counterpart in the registry
        with pytest.raises(NotImplementedError, match="only the dense"):
            Model(cfg)
        Model(dataclasses.replace(cfg, moe=None, cross_attn_every=8))
        return
    if over.get("family") in ("ssm", "hybrid"):
        # ported: the SSM and hybrid families (tests/test_torch_ssm*.py); a
        # MoE config relabelled ssm/hybrid (a MoE MLP, no SSMConfig) has no
        # counterpart in the registry
        with pytest.raises(NotImplementedError, match="only the dense"):
            Model(cfg)
        with pytest.raises(NotImplementedError, match="needs an SSMConfig"):
            Model(dataclasses.replace(cfg, moe=None))
        arch = "xlstm-350m" if over["family"] == "ssm" else "zamba2-7b"
        model = Model(get_config(arch))
        assert model.cfg.family == over["family"] and not model.supports_paging
        return
    with pytest.raises(NotImplementedError, match="only the dense"):
        Model(cfg)


def test_prepare_casts_mla_projections_and_keeps_gammas_f32(mini):
    cfg = dataclasses.replace(mini["model"].cfg, dtype="bfloat16")
    mixer = Model(cfg).prepare(mini["master"], "cpu")["layers"][0]["mixer"]
    assert {k: v.dtype for k, v in mixer.items()} == {
        "wq_a": torch.bfloat16, "q_norm": torch.float32, "wq_b": torch.bfloat16,
        "wkv_a": torch.bfloat16, "kv_norm": torch.float32, "wkv_b": torch.bfloat16,
        "wo": torch.bfloat16}
