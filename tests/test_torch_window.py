"""Sliding windows on the CPU against the JAX package: reduced mixtral-8x22b
(window 8, MoE 4 experts top-2) at float32, weights through ``convert.py``,
and the flash kernel's ``window`` band.

  * ``forward`` and ``prefill`` logits within 1e-5 of the reference's (the
    same one-pass GN attention under the band mask; the port's forward runs
    the flash kernel's plain version), and the prefill's ring equal to the
    reference's rolled cache;
  * ``decode_step`` logits within 1e-5 and ``generate`` tokens equal, with
    the ring wrapped (prompt and decode past the window); the slab engine's
    tokens and event log equal the JAX slab engine's on prompts that wrap;
  * the flash plain version with ``window``: within 1e-5 of the reference's
    masked one-pass ``_sdpa`` at s <= 2048 (the same function), within 5e-3
    of ``windowed_chunked`` at s = 2100 (the reference's own tolerance of
    its chunked GN paths against the one-pass one,
    ``tests/test_chunked_attention.py``), and a window past S equal to the
    causal call; its backward under the band against autograd through the
    masked one-pass version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models import attention as jax_attn
from repro.models.chunked_attention import windowed_chunked
from repro.serve.engine import generate as jax_generate
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_attention import ref as fa_ref
from repro_torch.models import attention as t_attn
from repro_torch.serve.engine import ServeConfig, generate

from _torch_parity import assert_same, jax_engine, pair, port_engine, prompt, run, to_port

ARCH = "mixtral-8x22b"
LOGITS_ATOL = 1e-5
CHUNKED_ATOL = 5e-3


@pytest.fixture(scope="module")
def mixtral():
    jmodel, jparams, model, master = pair(ARCH)
    assert model.cfg.sliding_window == 8 == jmodel.cfg.sliding_window
    return jmodel, jparams, model, model.prepare(master, "cpu"), master


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("s", [6, 20])
def test_forward_and_prefill_logits_match_jax(mixtral, s):
    jmodel, jparams, model, params, _ = mixtral
    toks = _tokens(2, s, s)
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    want = want[0] if isinstance(want, tuple) else want
    with torch.no_grad():
        got = model.forward(params, {"tokens": torch.as_tensor(toks)})
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)}, s + 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL, rtol=0)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_seq=s + 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGITS_ATOL, rtol=0)
    for key in ("k", "v"):  # a ring of min(max_seq, window), rolled into place
        assert cache[key].shape == jcache["layers"][key].shape
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache["layers"][key]),
                                   atol=1e-6, rtol=0)


def test_decode_steps_wrap_the_ring_and_generate_matches(mixtral):
    jmodel, jparams, model, params, _ = mixtral
    toks = _tokens(2, 11, 7)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_seq=24)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(toks)}, 24)
        nxt = np.asarray(jlogits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        for i in range(10):  # positions 11..20: the ring wraps again
            jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), 11 + i)
            tl, cache = model.decode_step(params, cache, torch.as_tensor(nxt), 11 + i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
            nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
        out = generate(model, params, {"tokens": torch.as_tensor(toks)},
                       ServeConfig(max_new_tokens=12))
    want = jax_generate(jmodel, jparams, {"tokens": jnp.asarray(toks)},
                        JaxServeConfig(max_new_tokens=12))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_slab_engine_tokens_equal_jax_with_the_ring_wrapped(mixtral):
    jmodel, jparams, model, _, master = mixtral
    reqs = [JaxRequest(id=i, tokens=prompt(256, n, 900 + i), max_new_tokens=6,
                       arrival_step=i) for i, n in enumerate((5, 13, 19, 9))]
    kw = {"num_slots": 2, "max_seq": 32}
    want = run(jax_engine(jmodel, jparams, sentinels=False, **kw), reqs)
    got = run(port_engine(model, master, **kw), to_port(reqs))
    assert_same(got, want)
    assert got["metrics"]["read_path"] == "slab"


def _heads(b, h, hkv, s, d, seed):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen)
    k = torch.randn(b, hkv, s, d, generator=gen)
    v = torch.randn(b, hkv, s, d, generator=gen)
    return q, k, v


@pytest.mark.parametrize("s,window", [(64, 16), (300, 37), (2048, 512)])
def test_flash_window_matches_reference_masked_sdpa(s, window):
    """The reference's one-pass path: ``_sdpa`` under
    ``causal_mask(s, s, window)``, in its (B, S, H, D) layout."""
    q, k, v = _heads(1, 4, 2, s, 16, s)
    got = fa_ops.gn_attention(q, k, v, causal=True, window=window)
    jcfg = jax_reduce_config(jax_get_config(ARCH), dtype="float32")
    want = jax_attn._sdpa(jcfg, *(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)),
                          jax_attn.causal_mask(s, s, window))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)


def test_flash_window_matches_windowed_chunked_past_2048():
    s, window = 2100, 512
    q, k, v = _heads(1, 2, 2, s, 16, 3)
    got = fa_ops.gn_attention(q, k, v, causal=True, window=window)
    want = windowed_chunked(*(jnp.asarray(t.numpy()) for t in (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CHUNKED_ATOL, rtol=0)


def test_flash_window_past_s_is_causal_and_refusals():
    q, k, v = _heads(2, 4, 1, 40, 8, 5)
    causal = fa_ops.gn_attention(q, k, v, causal=True)
    assert torch.equal(fa_ops.gn_attention(q, k, v, causal=True, window=40), causal)
    assert torch.equal(fa_ops.gn_attention(q, k, v, causal=True, window=4096), causal)
    mask = fa_ref.band_mask(5, 9, 3)  # row i sees (i + 4 - 3, i + 4]
    assert mask.tolist()[0] == [False, False, True, True, True, False, False, False, False]
    with pytest.raises(ValueError, match="window"):
        fa_ops.gn_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="window"):
        fa_ops.gn_attention(q, k, v, causal=True, window=-1)


def test_flash_window_backward_matches_autograd_of_the_masked_version():
    """The wrapper's backward under the band against autograd through the
    masked one-pass version with the straight-through Jacobian at the GN
    probabilities p (diag(p) - p p^T): the band must bound the gradient as
    it bounds the forward."""
    q, k, v = _heads(1, 2, 1, 24, 8, 9)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa_ops.gn_attention(q, k, v, causal=True, window=6)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), do)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sc = torch.einsum("bhqd,bhkd->bhqk", qs, ks.repeat_interleave(2, dim=1)) * 8 ** -0.5
    sc = torch.where(fa_ref.band_mask(24, 24, 6), sc, t_attn.NEG_INF)
    p = fa_ops.softmax_ops.gn_softmax(sc.detach())
    f = p * (sc - (p * sc).sum(dim=-1, keepdim=True))
    want_out = torch.einsum("bhqk,bhkd->bhqd", p + f - f.detach(), vs.repeat_interleave(2, dim=1))
    torch.testing.assert_close(out.detach(), want_out.detach(), atol=1e-6, rtol=0)
    want = torch.autograd.grad(want_out, (qs, ks, vs), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
