"""The fused score softmax (``kernels/gn_softmax/ops.py`` ``gn_softmax_scores``)
on the CPU, where it runs its plain version (``ref.scores_chain``).

- Bit for bit the chain each attention call site ran before it (the scores
  times the scale in their dtype, ``.float()``, ``torch.where(mask, ·,
  -1e30)``, ``gn_softmax``, ``.to(v.dtype)``), at f32 and bf16, over every
  site's mask broadcast: ``_sdpa``'s (B,1,S,T) and (1,1,S,T) under
  (B,KV,G,S,T) scores, the slab's and the paged read's (N,C,T), MLA's
  (B,1,S,T) and (N,1,C,T) under (B,H,S,T), and none (cross-attention);
  ragged widths and fully masked rows included.  The sites themselves
  (``_sdpa``, ``cross_attend_cached``, ``_attend_slab``,
  ``_paged_read_plain``, MLA's ``_softmax_av``) equal that chain bit for bit.
- Within ``tests/test_torch_kernels.py``'s softmax tolerances (1e-6 at f32,
  1e-2 at bf16) of the JAX chain on the same numpy inputs: ``jnp.where(mask,
  (scores * scale).astype(f32), NEG_INF)``, the reference's ``gn_softmax``
  through its Pallas kernel in interpret mode and through its oracle, then
  ``.astype`` (``src/repro/models/attention.py:44-47``, ``:439``, ``:619``,
  ``src/repro/models/mla.py:85``, ``:256``).
- Its backward bit for bit autograd through the chain.
- The sentinels' probe on the raw scores equal to the probe on the masked
  f32 scores, NaN and ±Inf injected included.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gn_softmax import ops as jax_sm_ops
from repro.kernels.gn_softmax.ref import gn_softmax_ref as jax_gn_softmax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.kernels.gn_softmax import ref as sm_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import mla as t_mla

NEG_INF = -1e30
DTYPES = [torch.float32, torch.bfloat16]


def _chain(scores, scale, mask, out_dtype):
    """The call sites' chain before the fused entry, op for op."""
    s = scores * torch.tensor(scale, dtype=scores.dtype)
    s = s.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return sm_ops.gn_softmax(s).to(out_dtype)


def _site(name, rng):
    """(raw scores, mask broadcastable to them, scale) of a call site's
    pattern: scores ~ N(0, 3^2) * dh^0.5, so the scaled rows are logits of
    scale ~3; ragged widths; some rows fully masked where a mask exists."""
    def scores(*shape, dh=16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3 * dh ** 0.5)

    if name == "sdpa-batch":  # (B,KV,G,S,T) under mask (B,1,S,T)[:, :, None]
        m = torch.from_numpy(rng.random((2, 1, 5, 13)) < 0.7)
        m[1, 0, 2] = False
        return scores(2, 2, 3, 5, 13), m[:, :, None], 16 ** -0.5
    if name == "sdpa-causal":  # (1,1,S,T) from causal_mask, T > S
        return scores(2, 2, 2, 6, 9), t_attn.causal_mask(6, 9)[:, :, None], 16 ** -0.5
    if name in ("slab", "paged"):  # (N,KV,G,C,T) under (N,C,T)[:, None, None]
        if name == "slab":
            valid = torch.from_numpy(rng.random((3, 4, 33)) < 0.5)
            valid[0, 1] = False
        else:
            rows = torch.tensor([[0, 1, 2, 3], [20, 21, 22, 23], [32, 32, 32, 32]])
            valid = torch.arange(33)[None, None, :] <= rows[:, :, None]
        return scores(3, 2, 2, 4, 33), valid[:, None, None], 16 ** -0.5
    if name == "mla-causal":  # (B,H,S,T) under (1,1,S,T)
        return scores(2, 4, 7, 7, dh=128), t_attn.causal_mask(7, 7), 128 ** -0.5
    if name == "mla-tick":  # (N,H,C,T) under (N,1,C,T)
        rows = torch.tensor([[4, 5, 6], [0, 0, 0]])
        valid = (torch.arange(130)[None, None, :] <= rows[:, :, None])[:, None]
        return scores(2, 4, 3, 130, dh=128), valid, 128 ** -0.5
    assert name == "cross"  # (B,KV,G,S,T), every column visible
    return scores(2, 2, 2, 3, 17), None, 16 ** -0.5


SITES = ["sdpa-batch", "sdpa-causal", "slab", "paged", "mla-causal", "mla-tick", "cross"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("site", SITES)
def test_fused_plain_version_is_the_chain_bitwise(site, dtype):
    raw, mask, scale = _site(site, np.random.default_rng(len(site)))
    raw = raw.to(dtype)
    want = _chain(raw, scale, mask, dtype)
    got = sm_ops.gn_softmax_scores(raw, scale, mask, dtype)
    assert got.dtype == dtype and got.shape == raw.shape
    assert torch.equal(got, want)
    assert torch.equal(sm_ref.gn_softmax_scores_ref(raw, scale, mask, dtype), want)
    assert torch.equal(sm_ops.gn_softmax_scores(raw, scale, mask, torch.float32),
                       _chain(raw, scale, mask, torch.float32))
    if mask is not None:  # masked entries exactly 0; a fully masked row uniform
        full = mask.expand(raw.shape)
        dead = ~full.any(-1)
        assert (got[~full & ~dead[..., None]] == 0).all()
        if dead.any():
            uniform = torch.tensor(1.0 / raw.shape[-1]).to(dtype)
            assert (got[dead] == uniform).all()
    assert sm_ops.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", ["sdpa-batch", "paged", "mla-tick", "cross"])
def test_fused_matches_the_jax_chain(site, dtype):
    """The reference's chain through its Pallas softmax (interpret mode)
    and through its oracle."""
    raw, mask, scale = _site(site, np.random.default_rng(len(site) + 7))
    tdt = getattr(torch, dtype)
    mine = sm_ops.gn_softmax_scores(raw.to(tdt), scale, mask, tdt).float().numpy()
    sj = (jnp.asarray(raw.numpy()).astype(dtype) * scale).astype(jnp.float32)
    if mask is not None:
        sj = jnp.where(jnp.asarray(mask.numpy()), sj, NEG_INF)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for ref in (jax_sm_ops.gn_softmax(sj, interpret=True), jax_gn_softmax_ref(sj)):
        want = np.asarray(ref.astype(dtype).astype(jnp.float32))
        np.testing.assert_allclose(mine, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("site", ["sdpa-batch", "mla-tick", "cross"])
def test_fused_backward_is_autograd_through_the_chain_bitwise(site, dtype):
    raw, mask, scale = _site(site, np.random.default_rng(len(site) + 3))
    w = torch.from_numpy(np.random.default_rng(1).normal(size=tuple(raw.shape))
                         .astype(np.float32))
    grads, outs = [], []
    for fn in (_chain, sm_ops.gn_softmax_scores):
        x = raw.to(dtype).requires_grad_(True)
        p = fn(x, scale, mask, dtype)
        (p.float() * w).sum().backward()
        grads.append(x.grad)
        outs.append(p.detach())
    assert torch.equal(outs[0], outs[1])
    assert grads[1].dtype == dtype and torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_probe_on_raw_scores_equals_probe_on_masked_f32_scores(dtype):
    """``_probe_sum_residual`` handed the raw product (what the sites pass
    now) against the masked f32 scores (what they passed before): NaN and
    ±Inf injected at visible and at masked columns, on live and parked
    lanes."""
    rng = np.random.default_rng(11)
    raw, mask, scale = _site("paged", rng)
    raw = raw.to(dtype)
    n, c = raw.shape[0], raw.shape[3]
    valid = mask[:, 0, 0]  # (N, C, T)
    lane_ok = torch.tensor([[True, True, False, False], [True] * 4, [True] * 4])
    for cell, val in (((0, 1, 0, 1, 0), float("nan")), ((1, 0, 1, 2, 5), float("inf")),
                      ((1, 1, 1, 2, 30), float("-inf")), ((2, 0, 0, 3, 32), float("nan")),
                      ((0, 0, 0, 2, 1), float("inf"))):  # the last on a parked lane
        raw[cell] = val
    masked = torch.where(mask, (raw * torch.tensor(scale, dtype=dtype)).float(), NEG_INF)
    pmat = sm_ops.gn_softmax(masked).to(dtype)
    out = torch.einsum("bkgst,btkd->bskgd", pmat, torch.ones(n, raw.shape[-1], 2, 16, dtype=dtype))
    want = t_attn._probe_sum_residual(pmat, masked, out, valid, lane_ok)
    got = t_attn._probe_sum_residual(pmat, raw, out, valid, lane_ok)
    assert torch.equal(got, want) and torch.isinf(got[1:]).all() and torch.isinf(got[0])
    raw[0, 1, 0, 1, 0] = 0.0  # slot 0 clean on its live lanes: a finite residual
    raw[0, 0, 0, 2, 1] = 0.0
    masked = torch.where(mask, (raw * torch.tensor(scale, dtype=dtype)).float(), NEG_INF)
    got = t_attn._probe_sum_residual(pmat, raw, out, valid, lane_ok)
    assert torch.equal(got, t_attn._probe_sum_residual(pmat, masked, out, valid, lane_ok))
    raw[0, 0, 0, 3, 32] = float("nan")  # masked column of a parked lane: unseen
    assert torch.isfinite(t_attn._probe_sum_residual(pmat, raw, out, valid, lane_ok)[0])


def _cfg(**kw):
    base = dict(softmax_impl="gn", n_heads=4, n_kv_heads=2, head_dim=16, q_features=64)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_call_sites_equal_their_chain_bitwise(dtype):
    """``_sdpa``, ``cross_attend_cached``, ``_attend_slab`` and
    ``_paged_read_plain`` (streamed and gathered) against the einsums and
    the chain they ran before, on the same inputs."""
    g = torch.Generator().manual_seed(0)
    cfg = _cfg()
    b, s, t, h, kv, dh = 2, 5, 9, 4, 2, 16

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    def old_attend(q, k, v, mask):
        qg = q.reshape(q.shape[0], q.shape[1], kv, h // kv, dh)
        p = _chain(torch.einsum("bskgd,btkd->bkgst", qg, k), dh ** -0.5, mask, v.dtype)
        return torch.einsum("bkgst,btkd->bskgd", p, v)

    q, k, v = rnd(b, s, h, dh), rnd(b, t, kv, dh), rnd(b, t, kv, dh)
    mask = t_attn.causal_mask(s, t)
    assert torch.equal(t_attn._sdpa(cfg, q, k, v, mask),
                       old_attend(q, k, v, mask[:, :, None]).reshape(b, s, h, dh))
    p = {"wq": rnd(64, 64), "wo": rnd(64, 64)}
    x = rnd(b, s, 64)
    qx = (x @ p["wq"]).reshape(b, s, h, dh)
    assert torch.equal(t_attn.cross_attend_cached(cfg, p, x, k, v),
                       old_attend(qx, k, v, None).reshape(b, s, 64) @ p["wo"])
    valid = torch.arange(t)[None, None, :] <= torch.tensor([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])[
        :, :, None]
    assert torch.equal(t_attn._attend_slab(cfg, p, q, k, v, valid),
                       old_attend(q, k, v, valid[:, None, None]).reshape(b, s, 64) @ p["wo"])
    nb, bs = 6, 4
    arena_k, arena_v = rnd(nb + 1, bs, kv, dh), rnd(nb + 1, bs, kv, dh)
    tables = torch.tensor([[3, 1, 4], [0, 5, 2]], dtype=torch.int32)
    rows = torch.tensor([[5, 6, 7, 8, 9], [0, 1, 2, 3, 4]])
    k_at = arena_k[tables.long()].reshape(b, -1, kv, dh)
    v_at = arena_v[tables.long()].reshape(b, -1, kv, dh)
    pvalid = torch.arange(k_at.shape[1])[None, None, :] <= rows[:, :, None]
    want = old_attend(q, k_at, v_at, pvalid[:, None, None]).reshape(b, s, h * dh)
    for streamed in (True, False):
        got = t_attn._paged_read_plain(q, arena_k, arena_v, tables, rows, None, streamed)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mla_softmax_av_equals_its_chain_bitwise(dtype):
    g = torch.Generator().manual_seed(1)
    mla = types.SimpleNamespace(qk_nope_head_dim=24, qk_rope_head_dim=8)
    cfg = _cfg(mla=mla)
    b, h, s, t = 2, 4, 3, 11
    raw = (torch.randn(b, h, s, t, generator=g) * 8).to(dtype)
    v = torch.randn(b, t, h, 16, generator=g).to(dtype)
    valid = (torch.arange(t)[None, None, :] <= torch.tensor([[4, 5, 6], [0, 1, 2]])[:, :, None])
    lanes = torch.tensor([[True, True, False], [True, True, True]])
    att, probe = t_mla._softmax_av(cfg, raw, v, valid[:, None], lanes)
    pmat = _chain(raw, 32 ** -0.5, valid[:, None], dtype)
    assert torch.equal(att, torch.einsum("bhst,bthd->bshd", pmat, v))
    masked = torch.where(valid[:, None], (raw * torch.tensor(32 ** -0.5, dtype=dtype)).float(),
                         NEG_INF)
    assert torch.equal(probe, t_attn._probe_sum_residual(pmat[:, :, None], masked[:, :, None],
                                                         att, valid, lanes))


def test_fused_entry_refuses_other_devices(monkeypatch):
    """Meta tensors stand in for another device with the shape-only route
    (the dry run's fake and meta tensors) turned off; with it on, they take
    that route."""
    x = torch.zeros(2, 8, device="meta")
    out = sm_ops.gn_softmax_scores(x, 0.5, None, torch.float32)
    assert out.is_meta and out.shape == x.shape and out.dtype == torch.float32
    monkeypatch.setattr(_build, "shape_only", lambda t: False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sm_ops.gn_softmax_scores(x, 0.5)
