"""Chunked attention past 2048 tokens: the port's ``models/chunked_attention.py``,
its exact and MLA long paths and the straight-through backward, against the
JAX package on the CPU at float32.

  * The streaming functions at (B 2, H 3, dh 16) (B 1 at 8192), in the
    style of ``tests/test_chunked_attention.py``: causal at 4096 and 8192 tokens
    (the hierarchy of halves, which the port follows there) within 1e-5
    for the exact softmax and 5e-3 for GN (the reference's own GN
    tolerance); the windowed scan and a rectangle within the same; a
    constant v returned to 1e-5 (Σp = 1 survives streaming); and at 3072
    tokens, where the reference's hierarchy asserts, the port's blocks held
    to the one-pass attention (exact: 1e-5; GN: 5e-3 against the flash
    kernel's plain version).
  * ``factorized_exp_ste``: its value bitwise the reference's, its gradient
    within 1e-6.
  * Reduced exact internlm2-1.8b and reduced minicpm3-4b (GN, MLA) at 4096
    tokens: forward logits within 2e-4 and greedy tokens equal to JAX.
  * The straight-through backward: past 2048 the reference differentiates
    ``factorized_exp_ste`` inside its stream; the port's flash backward takes
    the closed form of that gradient (``kernels/gn_attention/ops.py``), which
    equals it up to the LUT rounding of the rescales.  At the attention, on
    peaked scores (q, k ~ 1.5 N(0, 1)) against ``jax.grad`` of the
    reference's ``causal_chunked``: within 2e-3 relative (Frobenius) a
    gradient (about 1e-3 measured), where the one-pass softmax JVP's form
    misses by about 5e-2.
  * One training step's loss and gradients at 4096 tokens (reduced
    internlm2-1.8b cut to one layer, GN and exact) against ``jax.grad`` of
    the reference's loss: the loss within 1e-5 relative, every gradient
    leaf within 1e-5 relative (Frobenius; about 6e-7 measured at two
    layers); the exact softmax differentiates the port's own stream.  The
    launcher trains past 2048 (``--seq 2560``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.core.gn_softmax import factorized_exp_ste as jax_ste
from repro.core.luts import TPU_SOFTMAX_LUT
from repro.models import chunked_attention as jax_chunked
from repro.models.transformer import make_model as jax_make_model
from repro.serve import engine as jax_engine
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.gn_softmax import factorized_exp_ste
from repro_torch.kernels.gn_attention.ops import gn_attention
from repro_torch.kernels.gn_attention.ref import gn_attention_ref
from repro_torch.launch import train as train_launch
from repro_torch.models import chunked_attention as chunked
from repro_torch.models.transformer import make_model
from repro_torch.serve import engine

B, H, DH = 2, 3, 16
EXACT_ATOL, GN_ATOL = 1e-5, 5e-3
LOGITS_ATOL = 2e-4
GRAD_RTOL = 1e-5
STE_RTOL = 2e-3
LONG = 4096


def _qkv(seed, s, t=None, b=B, h=H, dh=DH):
    t = s if t is None else t
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * scale for shape, scale in
            (((b, h, s, dh), 1.5), ((b, h, t, dh), 1.5), ((b, h, t, dh), 1.0))]


def _exact_sdpa(q, k, v, causal=False, window=0):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq)[:, None] + (sk - sq)
        cols = torch.arange(sk)[None, :]
        mask = cols <= rows
        if window:
            mask &= cols > rows - window
        s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _both(fn_name, arrays, **kw):
    want = getattr(jax_chunked, fn_name)(*map(jnp.asarray, arrays), **kw)
    got = getattr(chunked, fn_name)(*map(torch.from_numpy, arrays), **kw)
    return got.numpy(), np.asarray(want)


# ------------------------------------------------------------ the stream --
@pytest.mark.parametrize("impl,atol", [("exact", EXACT_ATOL), ("gn", GN_ATOL)])
@pytest.mark.parametrize("s", [4096, 8192])
def test_causal_chunked_matches_jax(s, impl, atol):
    got, want = _both("causal_chunked", _qkv(s, s, b=B if s == 4096 else 1), impl=impl)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("impl,atol", [("exact", EXACT_ATOL), ("gn", GN_ATOL)])
def test_windowed_and_rectangle_match_jax(impl, atol):
    got, want = _both("windowed_chunked", _qkv(1, 3072), window=1024, impl=impl)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    q, k, v = _qkv(2, 256, t=3000)
    exp_fn, step = jax_chunked._exp_pair(impl, TPU_SOFTMAX_LUT)
    st = jax_chunked._init_state(q.shape[:-1], DH)
    want = jax_chunked._finalize(jax_chunked._stream_rect(
        *map(jnp.asarray, (q, k[:, :, :2048], v[:, :, :2048])), st, exp_fn, step, 1024,
        DH ** -0.5))
    t_exp, t_step = chunked._exp_pair(impl, TPU_SOFTMAX_LUT)
    st = chunked._init_state(q.shape[:-1], DH, "cpu")
    got = chunked._finalize(chunked._stream_rect(
        *map(torch.from_numpy, (q, k[:, :, :2048], v[:, :, :2048])), st, t_exp, t_step, 1024,
        DH ** -0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    # a kv length that is no multiple of the chunk: the shorter last chunk
    st = chunked._init_state(q.shape[:-1], DH, "cpu")
    tail = chunked._finalize(chunked._stream_rect(*map(torch.from_numpy, (q, k, v)), st,
                                                  t_exp, t_step, 1024, DH ** -0.5))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    oracle = (_exact_sdpa(qt, kt, vt) if impl == "exact"
              else gn_attention_ref(qt, kt, vt, causal=False))
    np.testing.assert_allclose(tail.numpy(), oracle.numpy(), atol=atol, rtol=0)


def test_constant_v_is_returned_exactly():
    q, k, _ = _qkv(3, LONG, b=1)
    v = np.full_like(q, 3.25)
    for fn, kw in (("causal_chunked", {}), ("windowed_chunked", {"window": 1000})):
        got = getattr(chunked, fn)(*map(torch.from_numpy, (q, k, v)), impl="gn", **kw)
        np.testing.assert_allclose(got.numpy(), 3.25, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["exact", "gn"])
def test_3072_matches_the_one_pass_path(impl):
    """3072 = 3 * 1024 has no hierarchy of halves (the reference asserts):
    the port's q blocks against its one-pass attention."""
    q, k, v = map(torch.from_numpy, _qkv(4, 3072, b=1))
    assert not chunked._halves_fit(3072, 1024, 1024)
    got = chunked.causal_chunked(q, k, v, impl=impl)
    if impl == "exact":
        np.testing.assert_allclose(got.numpy(), _exact_sdpa(q, k, v, causal=True).numpy(),
                                   atol=EXACT_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), gn_attention_ref(q, k, v, causal=True).numpy(),
                                   atol=GN_ATOL, rtol=0)


def test_factorized_exp_ste_value_bitwise_and_gradient():
    rng = np.random.default_rng(5)
    d = np.concatenate([rng.uniform(0, 30, 50000), np.arange(0, 40, 1 / 8),
                        [0.0, 1e-7, 1e30]]).astype(np.float32)
    want = np.asarray(jax_ste(jnp.asarray(d)))
    t = torch.from_numpy(d).requires_grad_(True)
    got = factorized_exp_ste(t)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    jgrad = np.asarray(jax.grad(lambda x: jax_ste(x).sum())(jnp.asarray(d)))
    np.testing.assert_allclose(t.grad.numpy(), jgrad, atol=1e-6, rtol=0)


def test_straight_through_backward_matches_jax_grad():
    q, k, v = _qkv(9, LONG, b=1, h=1)
    w = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: (jax_chunked.causal_chunked(*a, impl="gn") * w).sum(),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (gn_attention(*ts, causal=True) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert _rel(t.grad.numpy(), g) <= STE_RTOL


# --------------------------------------------------------------- models ---
def _pair(arch, **over):
    over = {"dtype": "float32", **over}
    jmodel = jax_make_model(jax_reduce_config(jax_get_config(arch), **over))
    tmodel = make_model(reduce_config(get_config(arch), **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, tmodel, tree


@pytest.fixture(scope="module", params=[("internlm2-1.8b", "exact"), ("minicpm3-4b", "gn")],
                ids=["internlm2-exact", "minicpm3-gn"])
def long_pair(request):
    arch, impl = request.param
    jmodel, jparams, tmodel, tree = _pair(arch, softmax_impl=impl)
    tparams = tmodel.prepare(params_from_numpy(tmodel, tree, device="cpu"), "cpu")
    return jmodel, jparams, tmodel, tparams


def test_forward_at_4096_matches_jax(long_pair):
    jmodel, jparams, tmodel, tparams = long_pair
    toks = np.random.default_rng(6).integers(0, 256, size=(1, LONG)).astype(np.int32)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)


def test_generate_at_4096_equals_jax(long_pair):
    jmodel, jparams, tmodel, tparams = long_pair
    toks = np.random.default_rng(7).integers(0, 256, size=(1, LONG)).astype(np.int32)
    want = jax_engine.generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                               jax_engine.ServeConfig(max_new_tokens=2))
    got = engine.generate(tmodel, tparams, {"tokens": torch.from_numpy(toks)},
                          engine.ServeConfig(max_new_tokens=2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["gn", "exact"])
def test_train_step_at_4096_matches_jax_grad(impl):
    jmodel, jparams, tmodel, tree = _pair("internlm2-1.8b", softmax_impl=impl, n_layers=1)
    toks = np.random.default_rng(8).integers(0, 256, size=(1, LONG)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, t: jmodel.loss(p, {"tokens": t})[0]))(
        jparams, jnp.asarray(toks))
    master = params_from_numpy(tmodel, tree, device="cpu")
    leaves = jax.tree.leaves(master)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = tmodel.loss(tmodel.prepare(master, "cpu"), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    errs = {n: _rel(g.numpy(), w) for n, g, w in zip(names, grads, jax.tree.leaves(jgrads))}
    assert len(errs) == len(leaves) and max(errs.values()) <= GRAD_RTOL, errs


def test_launcher_trains_past_2048(tmp_path):
    loss = train_launch.main(["--smoke", "--device", "cpu", "--seq", "2560", "--batch", "1",
                              "--steps", "1", "--outdir", str(tmp_path)])
    assert np.isfinite(loss)
