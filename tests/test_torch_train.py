"""The port's accuracy path on the CPU against the JAX package, at f32: the
differentiable GN kernels, the loss, one training step, AdamW, the exact
baseline and the training launcher (the Table I analogue's smoke is in
``test_torch_tables.py``, on the tables' shared training).

Same numpy weights (``convert.py``) and the same numpy batch on both sides.
Tolerances, with what was measured when they were set:
  * the kernels' backward against ``jax.grad`` through the reference's
    straight-through JVPs (``core/gn_softmax.py``, ``core/gn_layernorm.py``,
    the one-pass ``_sdpa`` for attention): 1e-5 relative L2 (measured
    ≤ 2e-7);
  * one train step: loss within 1e-5 relative (measured 2e-7), every
    gradient leaf within 1e-4 relative L2 (measured ≤ 5.1e-7 on reduced
    internlm2-1.8b, stablelm-1.6b and gpt-neo-1.3b), grad_norm 1e-5;
    updated parameters are not compared: AdamW's first step divides by
    sqrt(v) and so turns the gradients' last-bit differences on near-zero
    entries into differences of order lr;
  * ``adamw_update`` on identical gradients: 1e-6 relative; ``lr_at`` at
    every step: 1e-6; the int8 error feedback: equal up to one rounding;
  * the exact baseline's logits: 1e-5 (|logit| < 1), its engine's greedy
    tokens and ``generate``'s identical.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro.serve.engine import generate as jax_generate
from repro.serve.scheduler import Request as JaxRequest
from repro.train import optimizer as jax_opt
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate
from repro_torch.serve.scheduler import Request
from repro_torch.train import optimizer as t_opt
from repro_torch.train.loop import make_eval_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
# the modules (``repro.core`` exports functions of the same names)
jax_norm = importlib.import_module("repro.core.gn_layernorm")
jax_sm = importlib.import_module("repro.core.gn_softmax")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad(fn, *xs):
    """The port's gradients of sum(fn(*xs) * w) for a fixed random w."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    out = out if isinstance(out, tuple) else (out,)
    ws = [torch.from_numpy(np.random.default_rng(9 + i).normal(size=o.shape).astype(np.float32))
          for i, o in enumerate(out)]
    sum((o * w).sum() for o, w in zip(out, ws)).backward()
    return [t.grad.numpy() for t in ts], [w.numpy() for w in ws]


def _jax_grad(fn, ws, *xs):
    def f(*a):
        out = fn(*a)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws))
    return [np.asarray(g) for g in jax.grad(f, argnums=tuple(range(len(xs))))(
        *(jnp.asarray(x) for x in xs))]


# --------------------------------------------------- differentiable kernels --
def test_gn_softmax_backward_is_the_straight_through_jvp():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    x[:, 30:] = -1e30  # masked columns
    (got,), ws = _grad(sm_ops.gn_softmax, x)
    (want,) = _jax_grad(jax_sm.gn_softmax, ws, x)
    assert _rel(got, want) <= 1e-5
    assert np.abs(got.sum(axis=-1)).max() <= 1e-5  # the tangent of Σp = 1
    assert not torch.is_grad_enabled() or sm_ops.gn_softmax(torch.from_numpy(x)).grad_fn is None


@pytest.mark.parametrize("subtract_mean", [False, True], ids=["rms", "ln"])
def test_gn_norm_backward_matches_jax_jvp(subtract_mean):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    beta = (0.1 * rng.normal(size=48)).astype(np.float32)
    if subtract_mean:
        got, ws = _grad(norm_ops.gn_layernorm, x, gamma, beta)
        want = _jax_grad(jax_norm.gn_layernorm, ws, x, gamma, beta)
    else:
        got, ws = _grad(norm_ops.gn_rmsnorm, x, gamma)
        want = _jax_grad(jax_norm.gn_rmsnorm, ws, x, gamma)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("subtract_mean", [False, True], ids=["rms", "ln"])
def test_fused_add_norm_backward_sums_both_paths(subtract_mean):
    """(s, y) = (x + r, norm(x + r)): the gradient of x and of r is the
    gradient through y plus the one that reaches s, as the eager add then
    the norm gives it in JAX."""
    rng = np.random.default_rng(2)
    x, r = (rng.normal(size=(4, 32)).astype(np.float32) for _ in range(2))
    gamma = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    fused = (lambda a, b, g: norm_ops.gn_add_layernorm(a, b, g)) if subtract_mean else (
        lambda a, b, g: norm_ops.gn_add_rmsnorm(a, b, g))
    got, ws = _grad(fused, x, r, gamma)
    ref = jax_norm.gn_layernorm if subtract_mean else jax_norm.gn_rmsnorm
    want = _jax_grad(lambda a, b, g: (a + b, ref(a + b, g)), ws, x, r, gamma)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_gn_attention_backward_matches_one_pass_sdpa_grad(causal):
    """The flash kernel's Function against ``jax.grad`` of the reference's
    one-pass ``_sdpa`` (GN softmax, custom JVP), GQA 4 q / 2 kv heads, the
    layouts moved as ``self_attention`` moves them."""
    rng = np.random.default_rng(3)
    b, h, hkv, s, d = 2, 4, 2, 11, 16
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32) for _ in range(2))
    got, ws = _grad(lambda a, c, e: fa_ops.gn_attention(a, c, e, causal=causal), q, k, v)
    cfg = jax_reduce_config(jax_get_config("internlm2-1.8b"), dtype="float32")
    mask = jax_attn.causal_mask(s, s) if causal else jnp.ones((1, 1, s, s), bool)

    def sdpa(a, c, e):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        return t(jax_attn._sdpa(cfg, t(a), t(c), t(e), mask))

    want = _jax_grad(sdpa, ws, q, k, v)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


def test_no_graph_recorded_without_grad():
    """Serving never builds a graph: with grad off (or inputs that need
    none) each wrapper returns a plain tensor from the plain version."""
    x = torch.randn(3, 8, requires_grad=True)
    with torch.no_grad():
        outs = [sm_ops.gn_softmax(x), norm_ops.gn_rmsnorm(x),
                *norm_ops.gn_add_rmsnorm(x, x),
                fa_ops.gn_attention(x[None, None], x[None, None], x[None, None])]
    assert all(o.grad_fn is None for o in outs)
    assert sm_ops.gn_softmax(x.detach()).grad_fn is None


# ----------------------------------------------------------- train step --
def _pair(arch, **over):
    over = {"dtype": "float32", **over}
    jcfg = jax_reduce_config(jax_get_config(arch), **over)
    tcfg = reduce_config(get_config(arch), **over)
    jmodel, tmodel = jax_make_model(jcfg), make_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, tmodel, jax.tree.map(np.asarray, jparams)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch,impls,microbatches", [
    ("internlm2-1.8b", ("gn", "gn_rms"), 1),
    ("gpt-neo-1.3b", ("exact", "exact_ln"), 2),
    ("gpt-neo-1.3b", ("gn", "gn_ln"), 2),
], ids=["internlm2-gn", "gptneo-exact-mb2", "gptneo-gn-mb2"])
def test_train_step_matches_jax_f32(arch, impls, microbatches):
    """One step of ``make_train_step`` against the reference's (un-jitted)
    on the same weights and batch: loss, nll, grad_norm, lr, and every
    gradient leaf (the port's ``grads_of`` against ``jax.grad`` of the
    reference's loss on the microbatches, averaged)."""
    jmodel, jparams, tmodel, npp = _pair(arch, softmax_impl=impls[0], norm_impl=impls[1])
    toks = np.random.default_rng(4).integers(0, 256, size=(4, 20)).astype(np.int32)
    jstep = jax_make_train_step(jmodel, jax_opt.OptimizerConfig(**OPT), microbatches)
    _, _, jm = jstep(jparams, jax_opt.init_opt_state(jax_opt.OptimizerConfig(**OPT), jparams),
                     {"tokens": jnp.asarray(toks)})
    tparams = params_from_numpy(tmodel, npp, device="cpu")
    tstep = make_train_step(tmodel, t_opt.OptimizerConfig(**OPT), microbatches)
    _, state, tm = tstep(tparams, t_opt.init_opt_state(t_opt.OptimizerConfig(**OPT), tparams),
                         {"tokens": toks})
    assert int(state["step"]) == 1
    for key, tol in (("loss", 1e-5), ("nll", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
        assert abs(float(tm[key]) - float(jm[key])) <= tol * abs(float(jm[key])), key
    # the gradients, microbatch-averaged on both sides
    size = toks.shape[0] // microbatches
    jg = None
    for i in range(microbatches):
        one = {"tokens": jnp.asarray(toks[i * size:(i + 1) * size])}
        g = jax.grad(lambda p, b: jmodel.loss(p, b)[0])(jparams, one)
        jg = g if jg is None else jax.tree.map(jnp.add, jg, g)
    jg = jax.tree.map(lambda x: x / microbatches, jg)
    tparams = params_from_numpy(tmodel, npp, device="cpu")
    req = t_opt.tree_map(lambda p: p.requires_grad_(True), tparams)
    tg = None
    for i in range(microbatches):
        loss, _ = tmodel.loss(tmodel.prepare(req, "cpu"),
                              {"tokens": torch.from_numpy(toks[i * size:(i + 1) * size])})
        g = torch.autograd.grad(loss, t_opt.tree_leaves(req))
        tg = list(g) if tg is None else [a + b for a, b in zip(tg, g)]
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    errs = {n: _rel(a.numpy() / microbatches, b) for n, a, b in
            zip(names, tg, jax.tree.leaves(jg))}
    assert len(errs) == len(t_opt.tree_leaves(tparams))
    assert max(errs.values()) <= 1e-4, errs


def test_eval_step_and_loss_on_prepared_params():
    _, _, tmodel, npp = _pair("internlm2-1.8b")
    params = params_from_numpy(tmodel, npp, device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 12)).astype(np.int32)
    m = make_eval_step(tmodel)(params, {"tokens": toks})
    loss, _ = tmodel.loss(tmodel.prepare(params, "cpu"), {"tokens": torch.from_numpy(toks)})
    assert float(m["nll"]) == float(loss) and m["nll"].grad_fn is None


# ----------------------------------------------------------------- AdamW --
def _tree(rng, dtype=np.float32):
    return {"w": rng.normal(size=(5, 7)).astype(dtype), "b": {"g": rng.normal(size=7)
                                                            .astype(dtype)}}


@pytest.mark.parametrize("kw", [{}, {"grad_compression": 8}, {"state_dtype": "bfloat16"},
                                {"clip_norm": 0.1, "weight_decay": 0.0}])
def test_adamw_update_matches_jax(kw):
    rng = np.random.default_rng(6)
    p, g = _tree(rng), _tree(rng)
    jcfg, tcfg = jax_opt.OptimizerConfig(**OPT, **kw), t_opt.OptimizerConfig(**OPT, **kw)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = jax_opt.init_opt_state(jcfg, jp)
    tp = t_opt.tree_map(torch.from_numpy, _tree(np.random.default_rng(6)))
    ts = t_opt.init_opt_state(tcfg, tp)
    for _ in range(3):  # the moments and the error residual carry over
        jp, js, jm = jax_opt.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = t_opt.adamw_update(tcfg, tp, t_opt.tree_map(torch.from_numpy, g), ts)
    for a, b in zip(t_opt.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for leaf in ("m", "v"):
        for a, b in zip(t_opt.tree_leaves(ts[leaf]), jax.tree.leaves(js[leaf])):
            assert a.dtype == getattr(torch, tcfg.state_dtype)
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                       rtol=1e-5 if kw.get("state_dtype") else 1e-6, atol=1e-9)
    assert int(ts["step"]) == int(js["step"]) == 3
    for key in ("grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-6 * abs(float(jm[key]))


def test_lr_schedule_and_error_feedback_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=300, min_lr_ratio=0.1)
    steps = np.arange(0, 321)
    want = np.asarray(jax_opt.lr_at(jax_opt.OptimizerConfig(**cfg), jnp.asarray(steps)))
    got = t_opt.lr_at(t_opt.OptimizerConfig(**cfg), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rng = np.random.default_rng(7)
    g, e = _tree(rng), t_opt.tree_map(lambda a: a * 1e-3, _tree(rng))
    jd, je = jax_opt.compress_with_error_feedback(jax.tree.map(jnp.asarray, g),
                                                  jax.tree.map(jnp.asarray, e), 8)
    td, te = t_opt.compress_with_error_feedback(t_opt.tree_map(torch.from_numpy, g),
                                                t_opt.tree_map(torch.from_numpy, e), 8)
    for a, b in zip(t_opt.tree_leaves((td, te)), jax.tree.leaves((jd, je))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # dequantized + residual = the input plus the old residual (error feedback)
    for d_, r_, g_, e_ in zip(*(t_opt.tree_leaves(t) for t in (td, te, g, e))):
        np.testing.assert_allclose(d_.numpy() + r_.numpy(), g_ + e_, rtol=0, atol=1e-6)


# --------------------------------------------------------- exact baseline --
def test_exact_baseline_logits_and_tokens_match_jax():
    """The exact softmax and norms through ``forward``, ``generate`` and
    ``ContinuousEngine`` (the streamed read, as the reference's default)."""
    jmodel, jparams, tmodel, npp = _pair("gpt-neo-1.3b", softmax_impl="exact",
                                          norm_impl="exact_ln")
    master = params_from_numpy(tmodel, npp, device="cpu")
    params = tmodel.prepare(master, "cpu")
    toks = np.random.default_rng(8).integers(0, 256, size=(2, 16)).astype(np.int32)
    jl, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl = tmodel.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    want = jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks[:, :6])},
                        JaxServeConfig(max_new_tokens=5))
    got = generate(tmodel, params, {"tokens": toks[:, :6]}, ServeConfig(max_new_tokens=5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lens = (5, 9, 14, 7)
    reqs = [(i, np.random.default_rng(20 + i).integers(0, 256, size=n).astype(np.int32))
            for i, n in enumerate(lens)]
    jeng = JaxEngine(jmodel, jparams, num_slots=2, max_seq=32, cfg=JaxServeConfig(), chunk=4)
    jtok = {c.request_id: c.new_tokens.tolist() for c in jeng.run(
        [JaxRequest(id=i, tokens=t, max_new_tokens=5, arrival_step=i) for i, t in reqs])}
    teng = ContinuousEngine(tmodel, master, num_slots=2, max_seq=32, chunk=4, device="cpu")
    assert teng.read_path == "streamed" == jeng.metrics()["read_path"]
    ttok = {c.request_id: c.new_tokens.tolist() for c in teng.run(
        [Request(id=i, tokens=t, max_new_tokens=5, arrival_step=i) for i, t in reqs])}
    assert ttok == jtok
    m = teng.metrics()
    assert m["sentinel_checks"] > 0 and m["sentinel_violations"] == 0


def test_refusals_past_2048_and_of_other_impls():
    cfg = dataclasses.replace(reduce_config(get_config("gpt-neo-1.3b")), softmax_impl="exact",
                              dtype="float32")
    model = make_model(cfg)
    params = model.prepare(model.init(0, "cpu"), "cpu")
    long = {"tokens": torch.zeros(1, 2049, dtype=torch.int32)}
    # served past 2048 now, through the chunked stream (test_torch_chunked.py)
    assert bool(torch.isfinite(model.prefill(params, long)[0]).all())
    assert bool(torch.isfinite(model.forward(params, long)).all())
    t_attn.FORCE_PAGED_READ = "kernel"
    try:
        with pytest.raises(NotImplementedError, match="GN-only"):
            model.paged_read_path
    finally:
        t_attn.FORCE_PAGED_READ = None
    short = {"tokens": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(KeyError, match="nope"):  # as the reference's get_softmax
        make_model(dataclasses.replace(cfg, softmax_impl="nope")).forward(params, short)
    with pytest.raises(KeyError, match="nope"):
        make_model(dataclasses.replace(cfg, norm_impl="nope")).forward(params, short)
    softermax = make_model(dataclasses.replace(cfg, softmax_impl="softermax"))
    assert bool(torch.isfinite(softermax.forward(params, short)).all())
    assert softermax.paged_read_path == "gathered"
    # --mesh trains over gloo ranks (test_torch_mesh.py); a malformed one raises
    with pytest.raises(ValueError, match="DATAxMODEL"):
        train_launch.main(["--smoke", "--device", "cpu", "--mesh", "2by2"])
    # --seq past 2048 is no longer refused: it trains (test_torch_chunked.py
    # runs the launcher past 2048 and holds a step to jax.grad)


# ------------------------------------------------------------- launchers --
def _launch_train(outdir, *extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_FAIL_AT_STEP", None)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "4", "--seq", "16", "--batch", "4", "--checkpoint-every", "2",
         "--outdir", str(outdir), *extra], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)


def test_fail_at_then_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """``--fail-at 3`` dies with exit code 42 after step 3 (checkpoint at 2);
    the rerun resumes from step 2 and its step-4 checkpoint, parameters and
    AdamW state, equals an uninterrupted run's bit for bit (the CPU)."""
    whole = _launch_train(tmp_path / "whole")
    assert whole.returncode == 0, whole.stderr
    died = _launch_train(tmp_path / "cut", "--fail-at", "3")
    assert died.returncode == 42 and "[failure-injection] dying at step 3" in died.stdout
    assert store.latest_step(tmp_path / "cut" / "ckpt") == 2
    resumed = _launch_train(tmp_path / "cut")
    assert resumed.returncode == 0, resumed.stderr
    assert "[resume] from checkpoint step 2" in resumed.stdout
    a, man = store.restore_flat(tmp_path / "whole" / "ckpt", 4)
    b, _ = store.restore_flat(tmp_path / "cut" / "ckpt", 4)
    assert sorted(a) == sorted(b) and "0/embed/tok" in a and "1/step" in a
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert man["extra"] == {"arch": "internlm2-1.8b-smoke"}
    log = [json.loads(line) for line in (tmp_path / "cut" / "train_log.jsonl").open()]
    assert [r["step"] for r in log] == [1, 2, 3, 3, 4]


def test_serve_restores_a_training_checkpoint(tmp_path, capsys):
    train_launch.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
                       "--batch", "2", "--outdir", str(tmp_path)])
    out = serve_launch.main(["--smoke", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
                             "--batches", "1", "--batch-size", "2", "--new-tokens", "2"])
    text = capsys.readouterr().out
    assert "restored checkpoint step 2" in text and "seq ppl" in text
    (want,), _ = store.restore(tmp_path / "ckpt", 2, (out["model"].init(0, "cpu"),))
    got = out["params"]["lm_head"]["w"]  # prepared: cast to the config's dtype
    assert torch.equal(got, want["lm_head"]["w"].to(got.dtype))
    out = serve_launch.main(["--smoke", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt"),
                             "--continuous", "--requests", "2", "--new-tokens", "2",
                             "--dtype", "float32"])
    assert "token-identical to static path: 2/2" in capsys.readouterr().out
