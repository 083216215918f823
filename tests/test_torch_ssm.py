"""The port's sequence-state mixers (``models/ssm.py``) on the CPU against
the JAX package's (``repro/models/ssm.py``), at f32 on the same numpy
inputs, and the SSM and hybrid families' gradients against ``jax.grad``.

  * ``_causal_conv``: the shift-add chain (a serving call below
    ``_CONV_FUSED_MIN``), the grouped conv (a training call, and a serving
    call at 260 steps), and the state handed on with a carry and a per-row
    ``n_valid`` (each row against the reference's scalar ``n_valid``),
    within 1e-5;
  * ``_mlstm_chunked`` / ``_ssd_chunked`` against the reference's, from zero
    and from nonzero carries, within 1e-5;
  * ``mlstm_block`` and ``mamba2_block`` (reduced xlstm-350m and zamba2-7b
    with ``chunk=8`` through ``reduce_config(..., ssm=...)``): the
    recurrent form (12 steps), the chunked form (16 = 2 x 8), and a
    serving call with a carry and a per-row ``n_valid`` (0 parks a row,
    its carries bitwise unchanged), outputs and carries within 1e-5;
  * ``Model.loss`` and every parameter's gradient of both reduced families
    against ``jax.grad`` of the reference's loss (the mixers' norms through
    the GN norm's backward, zamba2's shared attention through the flash
    kernel's), within 1e-5 relative;
  * ``make_model`` builds the registry's xlstm-350m and zamba2-7b; ``prepare``
    casts the mixers' projections, conv taps and gate bias and keeps
    Mamba2's ``a_log``, ``dt_bias``, ``d_skip`` and ``norm`` f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models import ssm as jax_ssm
from repro.models.transformer import make_model as jax_make_model
from repro_torch.configs.base import SSMConfig
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm
from repro_torch.models.transformer import _tree_map, make_model

ARCHS = ("xlstm-350m", "zamba2-7b")
ATOL = 1e-5
GRAD_REL = 1e-5
CHUNK = 8


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _pair(arch: str, chunk: int = CHUNK):
    """(JAX model, params, the port's model, prepared params) of ``arch``
    reduced at f32 with SSM chunk ``chunk``."""
    base = jax_get_config(arch).ssm
    jcfg = jax_reduce_config(jax_get_config(arch), dtype="float32",
                             ssm=JaxSSMConfig(kind=base.kind, state_dim=8, head_dim=16,
                                              expand=2, conv_dim=4, chunk=chunk))
    cfg = reduce_config(get_config(arch), dtype="float32",
                        ssm=SSMConfig(kind=base.kind, state_dim=8, head_dim=16, expand=2,
                                      conv_dim=4, chunk=chunk))
    jmodel = jax_make_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    model = make_model(cfg)
    return jmodel, tree, model, params_from_numpy(model, tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    jmodel, tree, model, master = _pair(request.param)
    return {"arch": request.param, "jmodel": jmodel, "tree": tree, "model": model,
            "master": master, "params": model.prepare(master, "cpu")}


# ------------------------------------------------------------------ conv ---
@pytest.mark.parametrize("s,exact", [(10, True), (10, False), (260, True), (3, False)])
def test_causal_conv_forms(s, exact):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    want, wstate = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), exact=exact)
    got, state = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), exact=exact)
    _close(got, want)
    _close(state, wstate)


def test_causal_conv_state_per_row_n_valid():
    """A carry and a per-row n_valid: each row's output and handed-on state
    equal the reference's with that row's scalar n_valid."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    st = rng.normal(size=(3, 3, 5)).astype(np.float32)
    nv = np.array([0, 3, 6], np.int32)
    got, state = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(st), torch.from_numpy(nv))
    for b in range(3):
        want, wstate = jax_ssm._causal_conv(jnp.asarray(x[b:b + 1]), jnp.asarray(w),
                                            jnp.asarray(st[b:b + 1]), int(nv[b]))
        _close(got[b:b + 1], want)
        _close(state[b:b + 1], wstate)
    assert torch.equal(state[0], torch.from_numpy(st[0]))  # n_valid 0: the carry as it was


# --------------------------------------------------------- chunked forms ---
def _mlstm_inputs(rng, b, s, h, dh, zero_state):
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    i_raw = (rng.normal(size=(b, s, h)) * 2.0).astype(np.float32)
    f_raw = np.array(jax.nn.log_sigmoid(rng.normal(size=(b, s, h)) * 2.0 + 1.0), np.float32)
    if zero_state:
        carry = (np.zeros((b, h, dh, dh), np.float32), np.zeros((b, h, dh), np.float32),
                 np.full((b, h), -1e30, np.float32))
    else:
        carry = (rng.normal(size=(b, h, dh, dh)).astype(np.float32),
                 rng.normal(size=(b, h, dh)).astype(np.float32), np.zeros((b, h), np.float32))
    return q, k, v, i_raw, f_raw, carry


@pytest.mark.parametrize("zero_state", [True, False])
def test_mlstm_chunked_matches_the_reference(zero_state):
    q, k, v, i_raw, f_raw, carry = _mlstm_inputs(np.random.default_rng(3), 2, 16, 2, 4,
                                                 zero_state)
    want, wstate = jax_ssm._mlstm_chunked(*map(jnp.asarray, (q, k, v, i_raw, f_raw)),
                                          tuple(map(jnp.asarray, carry)), 4)
    got, state = ssm._mlstm_chunked(*map(torch.from_numpy, (q, k, v, i_raw, f_raw)),
                                    tuple(map(torch.from_numpy, carry)), 4)
    _close(got, want)
    for a, b in zip(state, wstate):
        _close(a, b)


@pytest.mark.parametrize("zero_state", [True, False])
def test_ssd_chunked_and_recurrent_match_the_reference(zero_state):
    rng = np.random.default_rng(4)
    b, s, h, dh, n = 2, 16, 3, 4, 5
    xs = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    B = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    dt = np.array(jax.nn.softplus(rng.normal(size=(b, s, h))), np.float32)
    decay = np.exp(dt * -np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    h0 = (np.zeros((b, h, dh, n), np.float32) if zero_state
          else rng.normal(size=(b, h, dh, n)).astype(np.float32))
    args = (xs, B, C, dt, decay, h0)
    for jfn, fn, extra in ((jax_ssm._ssd_chunked, ssm._ssd_chunked, (4,)),
                           (jax_ssm._ssd_recurrent, ssm._ssd_recurrent, ())):
        want, wh = jfn(*map(jnp.asarray, args), *extra)
        got, hh = fn(*map(torch.from_numpy, args), *extra)
        _close(got, want)
        _close(hh, wh)


# ---------------------------------------------------------------- blocks ---
def _block_fns(fam):
    if fam["arch"] == "xlstm-350m":
        return jax_ssm.mlstm_block, ssm.mlstm_block
    return jax_ssm.mamba2_block, ssm.mamba2_block


@pytest.mark.parametrize("s,exact", [(12, True), (16, False)])
def test_block_recurrent_and_chunked_forms(fam, s, exact):
    """12 steps take the recurrent form (the monolithic serving call, exact:
    the shift-add conv), 16 the chunked one (chunk 8; a training call: the
    grouped conv)."""
    jblk, blk = _block_fns(fam)
    cfg = fam["model"].cfg
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), fam["tree"]["layers"]["mixer"])
    want, wcarry = jblk(fam["jmodel"].cfg, jp, jnp.asarray(x), exact=exact)
    with torch.no_grad():
        got, carry = blk(cfg, fam["params"]["layers"][0]["mixer"], torch.from_numpy(x),
                         exact=exact)
    _close(got, want)
    for a, b in zip(carry, wcarry):
        _close(a, b)


def test_block_serving_call_per_row_n_valid(fam):
    """A chunk of 4 lanes from a carry with n_valid (3, 0, 4): each row
    equal to the reference's call with its scalar n_valid; the parked row's
    carries bitwise unchanged."""
    jblk, blk = _block_fns(fam)
    cfg = fam["model"].cfg
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 4, cfg.d_model)).astype(np.float32)
    specs = fam["model"]._carry_specs(3)
    carry = [rng.normal(size=shape).astype(np.float32) * 0.5 for shape, _ in specs.values()]
    if "m" in specs:
        carry[-1] = np.full_like(carry[-1], -1e30)
        carry[-1][0] = rng.normal(size=carry[-1].shape[1:])
    nv = np.array([3, 0, 4], np.int32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), fam["tree"]["layers"]["mixer"])
    with torch.no_grad():
        got, new = blk(cfg, fam["params"]["layers"][0]["mixer"], torch.from_numpy(x),
                       tuple(map(torch.from_numpy, carry)), torch.from_numpy(nv))
    for b in range(3):
        want, wnew = jblk(fam["jmodel"].cfg, jp, jnp.asarray(x[b:b + 1]),
                          tuple(jnp.asarray(c[b:b + 1]) for c in carry), n_valid=int(nv[b]))
        _close(got[b:b + 1, :max(nv[b], 1)], np.asarray(want)[:, :max(nv[b], 1)])
        for a, w in zip(new, wnew):
            _close(a[b:b + 1], w)
    for a, c in zip(new, carry):
        assert torch.equal(a[1], torch.from_numpy(c[1]))


# ------------------------------------------------------------- gradients ---
def test_loss_and_gradients_match_jax_grad(fam):
    toks = np.random.default_rng(5).integers(0, fam["model"].cfg.vocab,
                                             size=(2, 16)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, fam["tree"])
    (jloss, _), jgrads = jax.value_and_grad(fam["jmodel"].loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)})
    master = _tree_map(lambda _, t: t.clone().requires_grad_(True), fam["master"])
    loss, _ = fam["model"].loss(fam["model"].prepare(master, "cpu"),
                                {"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))

    def walk(node, jnode, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], jnode[k], f"{path}/{k}")
            return
        want = np.asarray(jnode, np.float64)
        got = node.grad.numpy().astype(np.float64)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= GRAD_REL, f"{path}: relative L2 {rel:.3g}"

    walk(master, jgrads, "")


# ------------------------------------------------------------- the model ---
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_configs_build_and_prepare_casts(arch):
    cfg = get_config(arch)
    model = make_model(cfg)
    mixer = model.param_specs()["layers"]["mixer"]
    assert "mlp" not in model.param_specs()["layers"]
    assert ("shared_attn" in model.param_specs()) == (cfg.family == "hybrid")
    small = make_model(dataclasses.replace(reduce_config(cfg), dtype="bfloat16"))
    prepared = small.prepare(small.init(0, "cpu"), "cpu")["layers"][0]["mixer"]
    f32 = {"a_log", "dt_bias", "d_skip", "norm"}
    assert set(prepared) == set(mixer)
    for name, t in prepared.items():
        assert t.dtype == (torch.float32 if name in f32 else torch.bfloat16), name
    assert not model.supports_paging
