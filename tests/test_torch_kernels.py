"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package: the paged GN read against the Pallas kernel in interpret mode
and against its gathered oracle, the norm wrappers against the Pallas norm
kernel, the GN softmax against the Pallas softmax kernel and its oracle,
and GN flash attention against the Pallas attention kernel.  Shared numpy
inputs; shuffled tables with stale entries; GQA; an empty sequence; the KV
prefix offset.  The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.luts import SoftmaxLUTConfig as JaxLUTConfig
from repro.kernels.gn_attention import ops as jax_fa_ops
from repro.kernels.gn_layernorm import ops as jax_norm_ops
from repro.kernels.gn_paged_attention import ops as jax_attn_ops
from repro.kernels.gn_paged_attention.ref import gn_paged_attention_chunk_ref
from repro.kernels.gn_softmax import ops as jax_sm_ops
from repro.kernels.gn_softmax.ref import gn_softmax_ref as jax_gn_softmax_ref
from repro_torch.core import gn_layernorm as core_ln
from repro_torch.core.luts import SoftmaxLUTConfig
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.kernels.gn_softmax import ops as sm_ops


def _chunk_inputs(bs, c, seed=0, v_ones=False):
    """3 live sequences + 1 empty one; H=4 over Hkv=2 (GQA group 2), D=16;
    tables are random physical ids, so every entry past a sequence's context
    is a stale or foreign block."""
    rng = np.random.default_rng(seed)
    n, h, kv, d, nb = 4, 4, 2, 16, 12
    max_bt = -(-32 // bs)
    q = rng.normal(size=(n, c, h, d)).astype(np.float32)
    k = rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    v = np.ones((nb, bs, kv, d), np.float32) if v_ones else \
        rng.normal(size=(nb, bs, kv, d)).astype(np.float32)
    tables = rng.integers(0, nb, size=(n, max_bt)).astype(np.int32)
    starts = np.array([9, 0, 17, 0], np.int32)
    n_valid = np.array([c, max(c - 1, 1), c, 0], np.int32)
    return q, k, v, tables, starts, n_valid


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _lane_ok(c, n_valid):
    return np.arange(c)[None, :] < n_valid[:, None]


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_read_matches_pallas_kernel_interpret(bs, c):
    """Online (Pallas) vs one-pass (port's plain read): equal up to LUT-entry
    rounding of the corrections — the reference's own 2e-4."""
    args = _chunk_inputs(bs, c)
    mine = attn_ops.gn_paged_attention_chunk(*_torch(*args)).numpy()
    ref = np.asarray(jax_attn_ops.gn_paged_attention_chunk(
        *[jnp.asarray(a) for a in args], interpret=True))
    np.testing.assert_allclose(mine, ref, atol=2e-4, rtol=0)
    assert (mine[3] == 0).all() and (ref[3] == 0).all()  # the empty sequence
    assert attn_ops.launches == 0


@pytest.mark.parametrize("bs,c", [(4, 1), (8, 4)])
def test_paged_read_matches_gathered_ref_tightly(bs, c):
    q, k, v, tables, starts, n_valid = _chunk_inputs(bs, c, seed=1)
    mine = attn_ops.gn_paged_attention_chunk(
        *_torch(q, k, v, tables, starts, n_valid)).numpy()
    group = q.shape[2] // k.shape[2]
    ref = np.asarray(gn_paged_attention_chunk_ref(
        jnp.asarray(q), jnp.repeat(k, group, axis=2), jnp.repeat(v, group, axis=2),
        jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(n_valid)))
    # the reference oracle attends a uniform mix of stale columns on a row
    # that sees none (the empty sequence); the kernels and the port read 0
    np.testing.assert_allclose(mine[:3], ref[:3], atol=2e-6, rtol=0)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("bs", [4, 8])
def test_paged_read_sum_to_one_through_block_table(bs, c):
    args = _chunk_inputs(bs, c, seed=5, v_ones=True)
    out = attn_ops.gn_paged_attention_chunk(*_torch(*args)).numpy()
    ok = _lane_ok(c, args[5])
    np.testing.assert_allclose(out[ok], 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subtract_mean", [False, True])
def test_norm_wrapper_matches_pallas_kernel_interpret(subtract_mean, dtype):
    """f32: within 1e-6 (the reference's mean vs the kernel's sum*(1/C));
    bf16: identical."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(24, 160)) * 2).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=160)).astype(np.float32)
    b = (0.1 * rng.normal(size=160)).astype(np.float32)
    beta_t = torch.from_numpy(b) if subtract_mean else None
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    mine = norm_ops.gn_layernorm(xt, torch.from_numpy(g), beta_t, subtract_mean=subtract_mean)
    ref = jax_norm_ops.gn_layernorm(jnp.asarray(x).astype(dtype), jnp.asarray(g),
                                    jnp.asarray(b) if subtract_mean else None,
                                    subtract_mean=subtract_mean, interpret=True)
    mine, ref = mine.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(mine, ref)
    assert norm_ops.launches == 0


def test_norm_wrappers_run_the_core_datapath_on_cpu():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(5, 64)).astype(np.float32))
    g = torch.linspace(0.5, 1.5, 64)
    assert torch.equal(norm_ops.gn_rmsnorm(x, g), core_ln.gn_rmsnorm(x, g))
    assert torch.equal(norm_ops.gn_layernorm(x, g, g), core_ln.gn_layernorm(x, g, g))


# ------------------------------------------------------------- GN softmax --
SOFTMAX_SHAPES = [(8, 128), (4, 7, 300), (1, 1000), (257, 64), (2, 3, 5, 130)]  # the reference's
LUT_CFGS = [(0, 1.0), (3, 1.0), (4, 0.5)]  # (frac_bits, delta_scale): the reference's sweep


def _logits(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=str)
def test_softmax_wrapper_matches_pallas_kernel_interpret(shape, dtype):
    """The reference's kernel-vs-oracle tolerances: 1e-6 at f32, 1e-2 at bf16."""
    x = _logits(shape, seed=len(shape) * 100 + shape[-1])
    mine = sm_ops.gn_softmax(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert mine.dtype == getattr(torch, dtype) and mine.shape == shape
    xj = jnp.asarray(x).astype(dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    mine = mine.float().numpy()
    for ref in (jax_sm_ops.gn_softmax(xj, interpret=True), jax_gn_softmax_ref(xj)):
        np.testing.assert_allclose(mine, np.asarray(ref.astype(jnp.float32)), atol=tol, rtol=0)
    assert sm_ops.launches == 0


@pytest.mark.parametrize("frac_bits,delta_scale", LUT_CFGS)
def test_softmax_wrapper_cfg_sweep(frac_bits, delta_scale):
    x = _logits((16, 200), seed=frac_bits)
    mine = sm_ops.gn_softmax(torch.from_numpy(x), SoftmaxLUTConfig(frac_bits, delta_scale=delta_scale))
    jcfg = JaxLUTConfig(frac_bits, delta_scale=delta_scale)
    for ref in (jax_sm_ops.gn_softmax(jnp.asarray(x), cfg=jcfg, interpret=True),
                jax_gn_softmax_ref(jnp.asarray(x), cfg=jcfg)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_softmax_wrapper_guarantees():
    """Σp = 1 within 2e-6 on wide-range logits; masked scores (-1e30, as the
    model's masks write them) give numerators of exactly 0."""
    x = _logits((64, 333), seed=9, scale=8.0)
    x[::3, 100:] = -1e30
    p = sm_ops.gn_softmax(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(p.astype(np.float64).sum(-1), 1.0, atol=2e-6, rtol=0)
    assert (p[::3, 100:] == 0).all()


# ------------------------------------------------------- GN flash attention --
# (B, H, Hkv, Sq, Sk, D): MHA; GQA 2:1 with ragged S; MQA with a KV prefix
# (Sk > Sq, the causal offset); small, as interpret mode is slow
ATTN_SHAPES = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 40, 40, 16), (1, 4, 1, 16, 64, 32)]


def _qkv(shape, seed, dtype="float32"):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, sq, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(b, hkv, sk, d)) * 0.5).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)],
            [jnp.asarray(a).astype(dtype) for a in (q, k, v)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_wrapper_matches_pallas_kernel_interpret(shape, causal):
    """Online (Pallas) vs one-pass (port's plain version): the reference's
    own 5e-5 at f32."""
    mine_in, ref_in = _qkv(shape, seed=shape[3] + causal)
    mine = fa_ops.gn_attention(*mine_in, causal=causal)
    ref = jax_fa_ops.gn_attention(*ref_in, causal=causal, interpret=True)
    assert mine.shape == mine_in[0].shape
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=5e-5, rtol=0)
    assert fa_ops.launches == 0


def test_attention_wrapper_bf16_matches_pallas_kernel_interpret():
    mine_in, ref_in = _qkv((1, 2, 2, 64, 64, 64), seed=11, dtype="bfloat16")
    mine = fa_ops.gn_attention(*mine_in, causal=True)
    ref = jax_fa_ops.gn_attention(*ref_in, causal=True, interpret=True)
    assert mine.dtype == torch.bfloat16
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2, rtol=0)


def test_attention_wrapper_rows_sum_to_one():
    (q, k, _), _ = _qkv((1, 4, 2, 24, 40, 16), seed=12)
    out = fa_ops.gn_attention(q, k, torch.ones_like(k), causal=True)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5, rtol=0)
