"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``), on the CPU, the same inputs and weights fed to both.

* ``quickstart``: each softmax's and norm's normalization error and its
  distance from the exact softmax equal the JAX ops' on the same numpy
  rows within two f32 ulps of 1 (2^-22: the port and jnp sum a row in
  other orders; measured at most 1.2e-7), and the hwsim datapaths' outputs
  bitwise (as ``tests/test_torch_hwsim.py`` holds them); the gradient's row
  sum ~0 and the model's logits finite.
* ``serve_batched``: each softmax's prompt perplexity within 1e-5
  (relative) of the JAX static path's on the converted weights at f32.
* ``train_lm``: the first three losses within 1e-4 (relative) of the JAX
  training loop's from the same converted init and batches.
* ``--devices 2`` of ``launch.serve --continuous`` and of
  ``examples.serve_continuous``, with ``--device cpu``: both sharded,
  every request served token for token as the static path, the sharded
  line printed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pair
from repro.core.api import get_norm as jax_norm
from repro.core.api import get_softmax as jax_softmax
from repro.core.metrics import layernorm_norm_error as jax_ln_err
from repro.core.metrics import softmax_norm_error as jax_sm_err
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import generate as jax_generate
from repro.serve.engine import perplexity as jax_perplexity
from repro.train.loop import make_train_step as jax_train_step
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.examples import quickstart, serve_batched, serve_continuous, train_lm
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import make_model

ROOT = Path(__file__).resolve().parents[1]
ERR_ATOL = 2.0 ** -22
PPL_RTOL = 1e-5
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def x64_alias():
    """The reference's ``jax.experimental.enable_x64`` (its hwsim), which the
    installed JAX lacks, aliased to ``jax.enable_x64`` while this module's
    tests run (``tests/test_torch_hwsim.py`` does the same)."""
    had, old = hasattr(jax.experimental, "enable_x64"), getattr(jax.experimental,
                                                                 "enable_x64", None)
    jax.experimental.enable_x64 = jax.enable_x64
    yield
    if had:
        jax.experimental.enable_x64 = old
    else:
        del jax.experimental.enable_x64


def test_quickstart_errors_equal_the_references(x64_alias, capsys):
    out = quickstart.main(["--device", "cpu"])
    assert "finite=True" in capsys.readouterr().out
    assert out["finite"] and abs(out["grad_sum"]) < 1e-6
    x, h = quickstart.inputs(0)
    exact = np.asarray(jax_softmax("exact")(jnp.asarray(x)))
    for name, (nerr, aerr) in out["softmax"].items():
        p = np.asarray(jax_softmax(name)(jnp.asarray(x)))
        assert nerr == pytest.approx(float(jnp.max(jax_sm_err(jnp.asarray(p)))), abs=ERR_ATOL)
        assert aerr == pytest.approx(float(np.abs(p - exact).max()), abs=ERR_ATOL)
    for name, err in out["norm"].items():
        y = jax_norm(name)(jnp.asarray(h))
        assert err == pytest.approx(float(jnp.max(jax_ln_err(y))), abs=ERR_ATOL), name
    for name, get_mine, get_ref, rows in (
            ("gn_hwsim", quickstart.get_softmax, jax_softmax, x),
            ("gn_ln_hwsim", quickstart.get_norm, jax_norm, h)):
        np.testing.assert_array_equal(get_mine(name)(torch.from_numpy(rows)).numpy(),
                                      np.asarray(get_ref(name)(jnp.asarray(rows))), err_msg=name)


def test_serve_batched_scores_equal_the_references():
    jmodel, jparams, model, master = pair("internlm2-1.8b")
    prompts = serve_batched.prompts_for(model.cfg, 2, 16)
    mine = serve_batched.serve(model.cfg, master, prompts, 4, "cpu")
    for impl, (toks, ppl, _) in mine.items():
        jm = jax_make_model(dataclasses.replace(jmodel.cfg, softmax_impl=impl))
        jbatch = {k: jnp.asarray(v) for k, v in prompts.items()}
        ref_ppl = float(jax_perplexity(jm, jparams, jbatch))
        assert ppl == pytest.approx(ref_ppl, rel=PPL_RTOL), impl
        ref_toks = np.asarray(jax_generate(jm, jparams, jbatch, JaxServeConfig(max_new_tokens=4)))
        np.testing.assert_array_equal(toks[:, :16], ref_toks[:, :16])  # the prompts


def _reference_train_lm():
    spec = importlib.util.spec_from_file_location("ref_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_losses_equal_the_references():
    steps, seq, batch = 3, 32, 4
    jcfg = _reference_train_lm().lm_config(False, "gn", "gn_ln")
    jmodel = jax_make_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    data = DataConfig(vocab=jcfg.vocab, seq_len=seq, global_batch=batch, seed=7)
    batches = [batch_at(data, s) for s in range(steps)]

    opt = JaxOptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    params = jax.tree.map(jnp.asarray, tree)
    state = jax_init_opt_state(opt, params)
    step_fn = jax.jit(jax_train_step(jmodel, opt))
    ref = []
    for b in batches:
        params, state, metrics = step_fn(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append(float(metrics["loss"]))

    cfg = train_lm.lm_config(False, "gn", "gn_ln")
    master = params_from_numpy(make_model(cfg), tree, device="cpu")
    _, losses = train_lm.train(cfg, steps, seq, batch, "cpu", params=master,
                               batches=lambda s: batches[s], log=lambda *a: None)
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("entry", ["launch.serve", "examples.serve_continuous"])
def test_devices_flag_shards_the_pool(entry, capsys):
    if entry == "launch.serve":
        out = launch_serve.main(["--smoke", "--device", "cpu", "--continuous", "--devices", "2",
                                 "--dtype", "float32", "--requests", "4", "--new-tokens", "4"])
        served, line = len(out["completions"]), "slot pool sharded over 2 devices (2 slots each)"
    else:
        out = serve_continuous.main(["--device", "cpu", "--devices=2", "--requests", "5",
                                     "--new-tokens", "4"])
        served, line = out["served"], "sharded: 2 devices x 2 slots"
    engine = out["engine"]
    assert engine.num_devices == 2 and engine.shard_devices == [torch.device("cpu")] * 2
    assert out["static_identical"] == served > 0
    m = engine.metrics()
    assert sum(m["device_admits"]) == served and 0 < m["shard_balance"] <= 1
    assert line in capsys.readouterr().out
