"""The port's MoE layer (GShard top-k routing, ``models/moe.py``) and the MoE
family (llama4-scout-17b-a16e) on the CPU against the JAX package.

  * ``apply_moe`` in both dispatches on the reference's test layer
    (tests/test_moe_dispatch.py: d 16, f 32, groups of 32, top-1 and top-2,
    capacity factors 0.5 / 1.25 / 4) and at the reduced model's router:
    the routing (top-k indices, capacity slots, kept choices) bitwise, the
    gates and y within 1e-6, the aux within 1e-6; the two dispatches equal;
    ties broken to the first index; the capacity arithmetic; a token count
    that does not split into groups refused;
  * ``prepare``'s dtypes leaf by leaf against the reference's ``.astype``
    sites at bfloat16; ``convert.py`` on the MoE tree (expert axis 0);
  * the reduced llama4-scout at f32 (4 experts, top-1, groups of 64):
    ``forward`` with its aux sums, ``loss`` (NLL + the MoE terms),
    ``generate`` tokens, ``perplexity``;
  * the continuous engine on the streamed read (the reference's CPU
    default; a tick is one routing group, so its parked and dead lanes
    compete for capacity as the reference's do): tokens and ``event_log``
    equal the JAX engine's over the fp pool; on the port's default
    kernel read, the reference's own MoE pin against ``static_reference``
    (tests/test_serve_fused.py: per-request common-prefix fraction of the
    whole sequence at least 0.5, mean at least 0.7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.core import get_softmax as jax_get_softmax
from repro.models import moe as jax_moe
from repro.models.layers import init_tree as jax_init_tree
from repro.serve import engine as jax_engine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.workload import required_max_seq
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import moe
from repro_torch.models.transformer import Model
from repro_torch.serve import engine

from _torch_parity import FAMILIES, pair, prompt, to_port

ARCH = FAMILIES["moe"]
ATOL = 1e-6
LENS = [5, 9, 14, 22, 7]  # the reference's mixed workload (tests/test_serve_paged.py)


@pytest.fixture(autouse=True)
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None


def _layer_cfgs(dispatch, e=4, k=2, group=32, cf=1.25):
    """The reference test's one-layer config, in both packages."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab=64, dtype="float32", softmax_impl="gn", moe_dispatch=dispatch)
    return (JaxModelConfig(moe=JaxMoEConfig(num_experts=e, top_k=k, capacity_factor=cf,
                                            group_size=group), **kw),
            ModelConfig(moe=MoEConfig(num_experts=e, top_k=k, capacity_factor=cf,
                                      group_size=group), **kw))


def _jax_routing(cfg, p, x):
    """The reference's routing of x, recomputed from its own functions and
    expressions (``apply_moe``'s lines up to the dispatch)."""
    m = cfg.moe
    b, s, d = x.shape
    g_sz = min(m.group_size, b * s)
    cap = max(int(g_sz * m.top_k * m.capacity_factor / m.num_experts), 1)
    xg = x.reshape(-1, g_sz, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"]).astype(jnp.float32)
    gates = jax_get_softmax(cfg.softmax_impl)(logits)
    idx, val = jax_moe._top_k(gates, m.top_k)
    onehot = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(xg.shape[0], g_sz * m.top_k, m.num_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    keep = jnp.any((pos < cap) & (onehot > 0), -1)
    return {"gates": gates, "idx": idx, "slot": jnp.sum(pos * onehot, -1),
            "keep": keep}


def _layer(dispatch, k, cf, seed=1, b=2, s=32, e=4):
    jcfg, cfg = _layer_cfgs(dispatch, e=e, k=k, cf=cf)
    jp = jax_init_tree(jax.random.PRNGKey(0), jax_moe.moe_specs(jcfg))
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), (b, s, 16)))
    p = {key: torch.from_numpy(np.asarray(v).copy()) for key, v in jp.items()}
    return jcfg, cfg, jp, p, x


# every (top-k, capacity factor) of the reference test once, each dispatch
# against the reference's same dispatch in turn (and the port's other one)
@pytest.mark.parametrize("dispatch,k,cf", [
    ("einsum", 1, 0.5), ("gather", 1, 1.25), ("einsum", 1, 4.0),
    ("gather", 2, 0.5), ("einsum", 2, 1.25), ("gather", 2, 4.0)])
def test_apply_moe_equals_jax(dispatch, k, cf):
    jcfg, cfg, jp, p, x = _layer(dispatch, k, cf)
    want, (jy, jaux) = jax.jit(lambda jp, x: (_jax_routing(jcfg, jp, x),
                                              jax_moe.apply_moe(jcfg, jp, x)))(jp, x)
    got = moe.route(cfg, p, torch.from_numpy(x))
    assert got["cap"] == max(int(32 * k * cf / 4), 1)
    for key in ("idx", "slot", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["gates"].numpy(), np.asarray(want["gates"]), atol=ATOL)
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    for key in ("load_balance", "router_z", "dropped_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-6, err_msg=key)
    if cf < 1.0:
        assert float(aux["dropped_frac"]) > 0  # capacity bites: dropped choices
    other = dataclasses.replace(cfg, moe_dispatch="gather" if dispatch == "einsum" else "einsum")
    np.testing.assert_allclose(moe.apply_moe(other, p, torch.from_numpy(x))[0].numpy(),
                               y.numpy(), atol=2e-6, rtol=0)


def test_top_k_ties_go_to_the_first_index():
    """GN probabilities sit on a grid, so equal gates happen; argmax on
    both sides takes the first, the second choice the next one."""
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.3, 0.1, 0.3], [0.0, 0.5, 0.5, 0.0]], np.float32)
    ji, jv = jax_moe._top_k(jnp.asarray(gates), 2)
    ti, tv = moe._top_k(torch.from_numpy(gates), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [1, 3]


@pytest.mark.parametrize("tokens,experts,k,cf,want", [
    (8, 16, 1, 1.25, 1),      # a decode tick of llama4-scout: cap 1
    (128, 16, 1, 1.25, 10),   # a fused tick (8 slots x chunk 16)
    (2048, 16, 1, 1.25, 160), # a full group
    (8, 4, 2, 1.25, 5),       # the reduced model's decode tick, top-2
])
def test_capacity_arithmetic(tokens, experts, k, cf, want):
    _, cfg = _layer_cfgs("einsum", e=experts, k=k, cf=cf, group=2048)
    x = torch.zeros(1, tokens, 16)
    p = {"router": torch.zeros(16, experts)}
    assert moe.route(cfg, p, x)["cap"] == want == max(int(tokens * k * cf / experts), 1)


def test_tokens_that_do_not_split_into_groups_are_refused():
    _, cfg = _layer_cfgs("einsum", group=32)
    p = {"router": torch.zeros(16, 4)}
    with pytest.raises(ValueError, match="groups of 32"):
        moe.route(cfg, p, torch.zeros(1, 48, 16))


# ------------------------------------------------------------- the model --
@pytest.fixture(scope="module")
def scout():
    """The reduced llama4-scout pair (JAX model, params, port model,
    masters) and the JAX engine's mixed-workload run on the streamed read
    (tokens, event log)."""
    jmodel, jparams, model, master = pair(ARCH)
    reqs = [JaxRequest(id=i, tokens=prompt(jmodel.cfg.vocab, n, 300 + i), max_new_tokens=4,
                       arrival_step=i) for i, n in enumerate(LENS)]
    eng = jax_engine.ContinuousEngine(jmodel, jparams, num_slots=2,
                                      max_seq=required_max_seq(reqs),
                                      cfg=jax_engine.ServeConfig(), chunk=4, block_size=4)
    assert eng.metrics()["read_path"] == "streamed"
    comps = eng.run(reqs)
    run = {"tokens": {c.request_id: np.asarray(c.new_tokens).tolist() for c in comps},
           "events": [tuple(e) for e in eng.event_log]}
    return {"jmodel": jmodel, "jparams": jparams, "model": model, "master": master,
            "prepared": model.prepare(master, "cpu"), "reqs": reqs, "run": run}


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def test_model_routes_the_jax_models_tokens(scout):
    """Layer 0's router over the embedded tokens: the same experts and
    capacity slots bitwise."""
    jmodel, jparams, model, params = (scout[k] for k in ("jmodel", "jparams", "model",
                                                         "prepared"))
    toks = np.stack([prompt(model.cfg.vocab, 32, 700 + i) for i in range(4)])
    x = np.asarray(jparams["embed"]["tok"])[toks]
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"]["mlp"])
    want = _jax_routing(jmodel.cfg, jlp, jnp.asarray(x))
    got = moe.route(model.cfg, params["layers"][0]["mlp"], torch.from_numpy(x))
    assert model.cfg.moe.top_k == 1 and got["cap"] == 20
    for key in ("idx", "slot", "keep"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_forward_aux_and_loss_equal_jax(scout):
    jmodel, jparams, model, params = (scout[k] for k in ("jmodel", "jparams", "model",
                                                         "prepared"))
    toks = np.stack([prompt(model.cfg.vocab, 32, 710 + i) for i in range(4)])
    jl, jaux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    tl, aux = model.forward(params, {"tokens": torch.from_numpy(toks)}, aux=True)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=0)
    assert torch.equal(model.forward(params, {"tokens": torch.from_numpy(toks)}), tl)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)
    jloss, jmetrics = jax.jit(jmodel.loss)(jparams, {"tokens": jnp.asarray(toks)})
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["nll"]), float(jmetrics["nll"]), rtol=1e-6)
    assert float(loss) > float(metrics["nll"])  # the MoE terms are in


def test_generate_and_perplexity_equal_jax(scout):
    """The static path (prefill, then decode steps routing a B-token group
    each) through ``generate``, and ``perplexity``."""
    jmodel, jparams, model, params = (scout[k] for k in ("jmodel", "jparams", "model",
                                                         "prepared"))
    toks = np.stack([prompt(model.cfg.vocab, 12, 720 + i) for i in range(3)])
    want = jax_engine.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                               jax_engine.ServeConfig(max_new_tokens=6))
    got = engine.generate(model, params, {"tokens": toks}, engine.ServeConfig(max_new_tokens=6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ptoks = np.stack([prompt(model.cfg.vocab, 32, 730 + i) for i in range(2)])
    want_ppl = jax_engine.perplexity(jmodel, jparams, {"tokens": jnp.asarray(ptoks)})
    got_ppl = engine.perplexity(model, params, {"tokens": ptoks})
    assert abs(got_ppl - want_ppl) <= 1e-6 * want_ppl


def test_engine_on_the_streamed_read_equals_jax(scout):
    t_attn.FORCE_PAGED_READ = "streamed"
    reqs = to_port(scout["reqs"])
    eng = engine.ContinuousEngine(scout["model"], scout["master"], num_slots=2,
                                  max_seq=required_max_seq(reqs), cfg=engine.ServeConfig(),
                                  chunk=4, block_size=4, device="cpu")
    comps = eng.run(reqs)
    assert eng.metrics()["read_path"] == "streamed"
    want = scout["run"]
    assert {c.request_id: c.new_tokens.tolist() for c in comps} == want["tokens"]
    assert [tuple(e) for e in eng.event_log] == want["events"]


def test_engine_on_the_kernel_read_within_the_reference_pin(scout):
    """The port's default read (the paged kernel; its plain version here):
    the reference's MoE pin against the static oracle (whole sequences).
    Dead lanes read the same on both reads on the CPU, so here the tokens
    also equal the streamed read's."""
    reqs = to_port(scout["reqs"])
    oracle = engine.static_reference(scout["model"], scout["prepared"], reqs,
                                     engine.ServeConfig())
    eng = engine.ContinuousEngine(scout["model"], scout["master"], num_slots=2,
                                  max_seq=required_max_seq(reqs), cfg=engine.ServeConfig(),
                                  chunk=4, block_size=4, device="cpu")
    comps = eng.run(reqs)
    assert eng.metrics()["read_path"] == "kernel"
    fracs = []
    for c in comps:
        want, got = oracle[c.request_id].tolist(), c.tokens.tolist()
        lcp = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
        fracs.append(lcp / len(want))
    assert min(fracs) >= 0.5 and float(np.mean(fracs)) >= 0.7, fracs
    assert {c.request_id: c.new_tokens.tolist() for c in comps} == scout["run"]["tokens"]


def test_prepare_dtypes_and_convert_on_the_moe_tree(scout):
    """At bfloat16 the router and the experts are cast (the reference's
    ``.astype(dt)`` at each einsum), the norms and the table stay f32;
    ``convert.py`` takes the reference tree with the expert axis first and
    refuses a transposed expert leaf."""
    cfg = dataclasses.replace(scout["model"].cfg, dtype="bfloat16")
    model = Model(cfg)
    prepared = model.prepare(scout["master"], "cpu")
    mlp = prepared["layers"][0]["mlp"]
    assert {k: v.dtype for k, v in mlp.items()} == dict.fromkeys(
        ("router", "wi", "wg", "wo"), torch.bfloat16)
    assert mlp["wi"].shape == (cfg.moe.num_experts, cfg.d_model, cfg.d_ff)
    assert prepared["layers"][0]["ln2"]["gamma"].dtype == torch.float32
    assert prepared["embed"]["tok"].dtype == torch.float32
    tree = jax.tree.map(np.asarray, scout["jparams"])
    master = params_from_numpy(model, tree, device="cpu")
    np.testing.assert_array_equal(master["layers"]["mlp"]["wo"].numpy(),
                                  tree["layers"]["mlp"]["wo"])
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["mlp"]["wi"] = np.swapaxes(tree["layers"]["mlp"]["wi"], 1, 2)
    with pytest.raises(ValueError, match="wi"):
        params_from_numpy(model, bad, device="cpu")
