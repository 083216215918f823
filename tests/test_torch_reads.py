"""The port's streamed and gathered paged reads on the CPU, against each
other and against the JAX package's reads of the same names.

``FORCE_PAGED_READ`` (``models/attention.py``) sends the tick's paged read
through the reference's streamed read (K gathered a tile of table columns
at a time) or its gathered oracle instead of the GN paged-attention kernel.
Held here, reduced internlm2-1.8b with GQA (4 q / 2 kv heads), weights
through ``convert.py``:
  * one fused tick with prefill, decode and parked lanes over fp and int8
    arenas, at f32 and bf16: the streamed read bit for bit the gathered read
    (logits and arenas), as the reference holds its two;
  * each read against the JAX read of the same name on shared inputs: f32
    within 1e-6 (float association of the projections; measured 1.5e-8);
    bf16 within one bf16 ulp of the output (2^-7 relative; measured bit for
    bit), since both packages round scores, probabilities and products to
    bf16 at the same points;
  * engines forced to a read: greedy tokens equal to the JAX engine's at
    f32 (the JAX engine reads through its streamed read on the CPU), and
    ``metrics()["read_path"]``;
  * the bf16 engine forced to ``"streamed"``, over the fp and the int8
    pool, against the JAX bf16 engines on the workload of
    tests/test_torch_serve.py and tests/test_torch_quant.py, the agreement
    pinned as measured;
  * an engine refuses to tick after the read path changed under it.
A fixture restores ``FORCE_PAGED_READ`` after each test, in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models import attention as jax_attn
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq
from test_torch_serve import CHUNK, _mixed, _tokens

ARCH = "internlm2-1.8b"
NB, BS = 48, 4
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None
    jax_attn.FORCE_PAGED_READ = None


@pytest.fixture(scope="module")
def weights():
    """JAX params (GQA: 2 kv heads) and their numpy copy, per dtype."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = jax_reduce_config(jax_get_config(ARCH), dtype=dtype, n_kv_heads=2)
        out[dtype] = (cfg, jax_make_model(cfg).init(jax.random.PRNGKey(3)))
    return out


def _port(weights, dtype):
    jcfg, jparams = weights[dtype]
    model = make_model(reduce_config(get_config(ARCH), dtype=dtype, n_kv_heads=2))
    master = params_from_numpy(model, jax.tree.map(np.asarray, jparams), device="cpu")
    return model, model.prepare(master, "cpu")


def _tick_inputs(cfg, kv_dtype):
    """A fused tick: slot 0 prefills 4 tokens at 0, slot 1 decodes at 37,
    slot 2 prefills 3 at 18, slot 3 is parked; shuffled tables with stale
    ids past each length; arenas of random prior content (quantized by
    ``paged_quant_write`` for int8), the sink block last."""
    rng = np.random.default_rng(7)
    positions = np.array([0, 37, 18, 0], np.int32)
    n_valid = np.array([4, 1, 3, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab, size=(4, CHUNK)).astype(np.int32)
    tables = rng.permutation(NB)[:4 * 11].reshape(4, 11).astype(np.int32)
    prior = {k: rng.normal(size=(cfg.n_layers, NB + 1, BS, cfg.n_kv_heads, cfg.head_dim))
             .astype(np.float32) for k in ("k", "v")}
    return tokens, positions, n_valid, tables, prior


def _cache(model, prior, kv_dtype):
    cache = model.init_paged_cache(NB, BS, "cpu", kv_dtype)
    for key in ("k", "v"):
        vals = torch.from_numpy(prior[key])
        if kv_dtype == "fp":
            cache[key].copy_(vals.to(cache[key].dtype))
            continue
        rows = torch.arange((NB + 1) * BS)
        for arena, scale, v in zip(cache[key], cache[f"{key}_scale"], vals):
            t_attn.paged_quant_write(arena.flatten(0, 1), scale, v.flatten(0, 1), rows, BS)
    return cache


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_read_bitwise_gathered_read(weights, dtype, kv_dtype):
    """One fused tick of the model through each read: logits and every real
    arena block (and int8 scale) bit for bit.  The table is 11 columns wide,
    so the streamed read's last tile is a partial one."""
    model, params = _port(weights, dtype)
    tokens, positions, n_valid, tables, prior = _tick_inputs(model.cfg, kv_dtype)
    got = {}
    for path in ("streamed", "gathered"):
        t_attn.FORCE_PAGED_READ = path
        assert model.paged_read_path == path
        cache = _cache(model, prior, kv_dtype)
        logits = model.fused_step_slots_paged(
            params, cache, *(torch.from_numpy(a) for a in (tokens, positions, n_valid, tables)))
        got[path] = (logits, {k: v[:, :NB] for k, v in cache.items()})
    assert torch.equal(got["streamed"][0], got["gathered"][0])
    for key, arena in got["gathered"][1].items():
        assert torch.equal(got["streamed"][1][key], arena), key
    assert torch.isfinite(got["streamed"][0]).all()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["streamed", "gathered"])
def test_read_matches_jax_read_of_same_name(weights, dtype, kv_dtype, path):
    """Layer 0's ``attn_paged_chunk`` in both packages through the read of
    one name, on the same x, tables and arenas (the port's carry the sink
    block, which the reference's writes drop instead): outputs of the valid
    lanes and the written arenas (int8: bit for bit)."""
    jcfg, jparams = weights[dtype]
    model, params = _port(weights, dtype)
    cfg = model.cfg
    _, positions, n_valid, tables, prior = _tick_inputs(cfg, kv_dtype)
    x = np.random.default_rng(8).normal(size=(4, CHUNK, cfg.d_model)).astype(np.float32)
    cache = _cache(model, prior, kv_dtype)
    k, v = cache["k"][0], cache["v"][0]
    scales = (cache["k_scale"][0], cache["v_scale"][0]) if kv_dtype == "int8" else None
    dt = getattr(jnp, dtype)
    jk, jv = (jnp.asarray(a[:NB].float().numpy()).astype(jnp.int8 if scales else dt)
              for a in (k, v))
    jscales = None if scales is None else tuple(jnp.asarray(s[:NB].numpy()) for s in scales)

    t_attn.FORCE_PAGED_READ = jax_attn.FORCE_PAGED_READ = path
    mixer = jax.tree.map(lambda a: a[0], jparams["layers"])["mixer"]
    res = jax_attn.attn_paged_chunk(jcfg, mixer, jk, jv, jnp.asarray(x).astype(dt),
                                    jnp.asarray(positions), jnp.asarray(n_valid),
                                    jnp.asarray(tables), scales=jscales)
    want, jarenas = np.asarray(res[0].astype(jnp.float32)), res[1]
    got = t_attn.attn_paged_chunk(cfg, params["layers"][0]["mixer"], k, v,
                                  torch.from_numpy(x).to(getattr(torch, dtype)),
                                  *(torch.from_numpy(a) for a in (positions, n_valid, tables)),
                                  scales).float().numpy()
    lane = np.arange(CHUNK)[None, :] < n_valid[:, None]
    err = np.abs(got - want)[lane]
    bound = 1e-6 if dtype == "float32" else BF16_REL * np.abs(want[lane])
    assert np.all(err <= bound), err.max()
    if kv_dtype == "int8":  # the same writes: bit for bit
        np.testing.assert_array_equal(k[:NB].numpy(), np.asarray(jarenas[0]).reshape(k[:NB].shape))
        np.testing.assert_array_equal(cache["k_scale"][0][:NB].numpy(), np.asarray(jarenas[2]))


@pytest.fixture(scope="module")
def jax_engines():
    """The JAX engine's greedy tokens on the mixed workload (block 4): at
    f32 over the fp pool, at bf16 over the fp and the int8 pool; and its
    weights as numpy (reduced internlm2-1.8b, the seed of
    tests/test_torch_serve.py)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = jax_reduce_config(jax_get_config(ARCH), dtype=dtype)
        model = jax_make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        reqs = _mixed(cfg.vocab, JaxRequest)
        for kv_dtype in ("fp", "int8") if dtype == "bfloat16" else ("fp",):
            eng = JaxEngine(model, params, num_slots=2, max_seq=required_max_seq(reqs),
                            cfg=JaxServeConfig(), chunk=CHUNK, block_size=CHUNK,
                            kv_dtype=kv_dtype, sentinels=False)
            out[dtype, kv_dtype] = _tokens(eng.run(reqs))
            assert eng.metrics()["read_path"] == "streamed"
        out[dtype] = jax.tree.map(np.asarray, params)
    return out


def _engine(jax_engines, dtype, kv_dtype):
    model = make_model(reduce_config(get_config(ARCH), dtype=dtype))
    params = params_from_numpy(model, jax_engines[dtype], device="cpu")
    reqs = _mixed(model.cfg.vocab, Request)
    return ContinuousEngine(model, params, num_slots=2, max_seq=required_max_seq(reqs),
                            cfg=ServeConfig(), chunk=CHUNK, block_size=CHUNK,
                            kv_dtype=kv_dtype, device="cpu"), reqs


@pytest.mark.parametrize("path", ["streamed", "gathered"])
def test_engine_forced_read_matches_jax_engine_f32(jax_engines, path):
    t_attn.FORCE_PAGED_READ = path
    eng, reqs = _engine(jax_engines, "float32", "fp")
    assert _tokens(eng.run(reqs)) == jax_engines["float32", "fp"]
    assert eng.metrics()["read_path"] == path
    assert eng.pool.blocks_in_use == 0 and eng.pool.num_free == eng.pool.num_slots


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_bf16_streamed_engine_agreement(jax_engines, kv_dtype):
    """The port's kernel read keeps bf16 scores in f32 and agrees with the
    JAX bf16 engine on 17 of 20 tokens (tests/test_torch_serve.py,
    tests/test_torch_quant.py).  Forced to the streamed read, the port
    rounds where the reference's read rounds.  Measured on this workload:
    20 of 20 tokens agree over the fp pool and over the int8 pool.  The test
    pins that measurement."""
    t_attn.FORCE_PAGED_READ = "streamed"
    eng, reqs = _engine(jax_engines, "bfloat16", kv_dtype)
    mine, ref = _tokens(eng.run(reqs)), jax_engines["bfloat16", kv_dtype]
    agree = sum(a == b for i in ref for a, b in zip(mine[i], ref[i]))
    total = sum(len(t) for t in ref.values())
    print(f"bf16 {kv_dtype} streamed greedy agreement with the JAX engine: {agree}/{total}")
    assert agree >= 20


def test_read_path_fixed_at_construction_and_names_checked(jax_engines):
    eng, reqs = _engine(jax_engines, "float32", "fp")
    assert eng.metrics()["read_path"] == "kernel"
    eng.submit(reqs[0])
    assert eng.step()
    t_attn.FORCE_PAGED_READ = "streamed"
    with pytest.raises(RuntimeError, match="FORCE_PAGED_READ"):
        eng.step()
    t_attn.FORCE_PAGED_READ = "pallas"
    with pytest.raises(ValueError, match="FORCE_PAGED_READ"):
        eng.model.paged_read_path
