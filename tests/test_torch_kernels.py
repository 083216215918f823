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
from repro_torch.core.gn_softmax import delta_index, factorized_exp
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subtract_mean", [False, True])
def test_fused_add_norm_plain_is_the_add_then_the_norm(subtract_mean, dtype):
    """The fused entry's plain version: s is the eager x + r and y the plain
    norm of s, bit for bit."""
    from repro_torch.kernels.gn_layernorm import ref as norm_ref

    rng = np.random.default_rng(7)
    x, r = (torch.from_numpy(rng.normal(size=(6, 5, 96)).astype(np.float32)).to(dtype)
            for _ in range(2))
    g = torch.from_numpy((1 + 0.1 * rng.normal(size=96)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=96)).astype(np.float32)) if subtract_mean else None
    s, y = norm_ref.gn_add_layernorm_ref(x, r, g, b, subtract_mean=subtract_mean)
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, x + r)
    assert torch.equal(y, norm_ref.gn_layernorm_ref(x + r, g, b, subtract_mean=subtract_mean))
    ws, wy = norm_ops.gn_add_layernorm(x, r, g, b, subtract_mean=subtract_mean)
    assert torch.equal(ws, s) and torch.equal(wy, y)
    assert norm_ops.launches == norm_ops.launches_fused == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subtract_mean", [False, True])
def test_fused_add_norm_wrapper_matches_pallas_kernel_interpret(subtract_mean, dtype):
    """The fused wrapper's y against the Pallas norm kernel run on the same
    sum, with the unfused wrapper's tolerances: f32 within 1e-6, bf16
    identical."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(24, 160)) * 2).astype(np.float32)
    r = rng.normal(size=(24, 160)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=160)).astype(np.float32)
    b = (0.1 * rng.normal(size=160)).astype(np.float32)
    tdt = getattr(torch, dtype)
    s, mine = norm_ops.gn_add_layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt),
                                        torch.from_numpy(g),
                                        torch.from_numpy(b) if subtract_mean else None,
                                        subtract_mean=subtract_mean)
    ref = jax_norm_ops.gn_layernorm(jnp.asarray(s.float().numpy()).astype(dtype), jnp.asarray(g),
                                    jnp.asarray(b) if subtract_mean else None,
                                    subtract_mean=subtract_mean, interpret=True)
    mine, ref = mine.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "stablelm-1.6b"])  # gn_rms, gn_ln
def test_apply_add_norm_is_the_add_then_apply_norm(arch, dtype):
    from repro_torch.configs.registry import get_config, reduce_config
    from repro_torch.models.layers import apply_add_norm, apply_norm

    cfg = reduce_config(get_config(arch), dtype=dtype)
    rng = np.random.default_rng(9)
    x, r = (torch.from_numpy(rng.normal(size=(3, 4, cfg.d_model)).astype(np.float32))
            .to(getattr(torch, dtype)) for _ in range(2))
    p = {"gamma": torch.from_numpy((1 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32))}
    if cfg.norm_impl == "gn_ln":
        p["beta"] = torch.from_numpy((0.1 * rng.normal(size=cfg.d_model)).astype(np.float32))
    s, h = apply_add_norm(cfg, p, x, r)
    assert torch.equal(s, x + r)
    assert torch.equal(h, apply_norm(cfg, p, x + r))


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


# ------------------------------------------- the bf16 split of P·V (CUDA) --
def _splits_exactly(y: torch.Tensor) -> torch.Tensor:
    """Per element: y == bf16(y) + bf16(y - bf16(y)) in f32, bit for bit."""
    hi = y.to(torch.bfloat16)
    lo = (y - hi.float()).to(torch.bfloat16)
    return (hi.float() + lo.float()).view(torch.int32) == y.view(torch.int32)


@pytest.mark.parametrize("value_bits", [15, 16, 17])
@pytest.mark.parametrize("frac_bits,delta_scale", LUT_CFGS)
def test_lut_numerators_split_exactly_into_two_bf16(frac_bits, delta_scale, value_bits):
    """The tensor-core flash attention feeds each LUT numerator y to P·V as
    hi + lo, two bf16: exact for every Δ index the LUT can produce."""
    cfg = SoftmaxLUTConfig(frac_bits, delta_scale=delta_scale, lut_value_bits=value_bits)
    idx = torch.arange(cfg.max_delta_int + 1, dtype=torch.int32)
    delta = idx.float() * cfg.step
    assert torch.equal(delta_index(delta, cfg), idx)  # every index reached once
    y = factorized_exp(delta, cfg)
    assert y.dtype == torch.float32 and float(y.max()) == 1.0 and float(y.min()) >= 0.0
    assert bool(_splits_exactly(y).all())


@pytest.mark.parametrize("bits", [15, 16, 17, 18])
def test_bf16_split_holds_up_to_the_wrappers_limit(bits):
    """Every multiple of 2^-bits in [0, 1] splits exactly iff bits <= 17,
    the limit the bf16 wrapper enforces (the first failure on the 2^-18
    grid is 0.50098, 131329 / 2^18)."""
    y = (torch.arange(2**bits + 1, dtype=torch.float64) / 2**bits).float()
    ok = _splits_exactly(y)
    assert bool(ok.all()) == (bits <= fa_ops.MAX_BF16_LUT_BITS)
    if bits == 18:
        assert int((~ok).sum()) == 32768 and int((~ok).nonzero()[0]) == 131329


# ------------------------------- the tensor-core paged read's arithmetic (CUDA) --
NEG_INF = -1e30


def _lut(delta: torch.Tensor, cfg: SoftmaxLUTConfig) -> torch.Tensor:
    """factorized_exp with the kernels' saturation: Δ past the LUT is 0."""
    past = torch.round(delta * (1.0 / cfg.step)) > cfg.max_delta_int
    return torch.where(past, 0.0, factorized_exp(delta, cfg))


def _hi_lo(y: torch.Tensor) -> torch.Tensor:
    """y as the tensor cores take it: bf16(y) + bf16(y - bf16(y))."""
    hi = y.to(torch.bfloat16).float()
    return hi + (y - hi).to(torch.bfloat16).float()


def _fold(states, cfg: SoftmaxLUTConfig):
    """(m, l, acc) states merged: their max, then each state's (l, acc) times
    its LUT'd correction, 0 for a state that saw nothing, in order."""
    m = torch.stack([s[0] for s in states]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(states[0][2])
    cap = cfg.step * (cfg.max_delta_int + 1)
    for m_s, l_s, acc_s in states:
        c = torch.where(m_s > NEG_INF / 2, _lut((m - m_s).clamp(0.0, cap), cfg), 0.0)
        l, acc = l + l_s * c, acc + acc_s * c[:, None]
    return m, l, acc


def _emulate_tc_read(q, k, v, tables, starts, n_valid, cfg, sm_scale, scales=None, keys=16,
                     streams=2, range_pages=5):
    """csrc/gn_paged_attention.cu's tensor-core design, step by step in f32:
    chain ranges of ``range_pages`` pages, tiles of ``keys`` keys (several
    pages), each tile's keys cut into ``streams`` slices with their own
    (m, l, acc) folded at the range's end, the ranges merged; scores q·k,
    then (int8) the key's k_scale, then sm_scale; P·V over y (int8: y times
    the key's v_scale in f32) split into bf16 hi + lo; l sums y."""
    n_seq, c, h, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kw, cap = keys // streams, cfg.step * (cfg.max_delta_int + 1)
    out = torch.zeros(n_seq, c, h, d)
    for n in range(n_seq):
        start, length = int(starts[n]), int(starts[n] + n_valid[n])
        pages = -(-length // bs)
        pos = start + torch.arange(g * c) % c  # row r = head g * C + chunk row i
        for kvh in range(hkv):
            rows = q[n, :, kvh * g:(kvh + 1) * g].permute(1, 0, 2).reshape(g * c, d).float()
            ranges = []
            for j0 in range(0, pages, range_pages):
                c_begin, c_end = j0 * bs, min(min(j0 + range_pages, pages) * bs, length)
                states = []
                for ks in range(streams):
                    m, l = torch.full((g * c,), NEG_INF), torch.zeros(g * c)
                    acc = torch.zeros(g * c, d)
                    for c0 in range(c_begin + ks * kw, c_end, keys):
                        cols = torch.arange(c0, min(c0 + kw, c_end))
                        page = tables[n, cols // bs].long()
                        kk, vv = k[page, cols % bs, kvh].float(), v[page, cols % bs, kvh].float()
                        s = rows @ kk.T
                        if scales is not None:
                            s = s * scales[0][page]
                        vis = cols[None] <= pos[:, None]
                        s = torch.where(vis, s * sm_scale, NEG_INF)
                        started = m > NEG_INF / 2
                        m_new = torch.ceil(torch.maximum(m, s.amax(1)) / cfg.step) * cfg.step
                        m_new = torch.where(vis.any(1) | started, m_new, m)
                        corr = torch.where(started, _lut((m_new - m).clamp(0.0, cap), cfg), 0.0)
                        live = vis & (m_new > NEG_INF / 2)[:, None]
                        y = torch.where(live, _lut((m_new[:, None] - s).clamp_min(0.0), cfg), 0.0)
                        z = y if scales is None else y * scales[1][page]
                        l, acc, m = l * corr + y.sum(1), acc * corr[:, None] + _hi_lo(z) @ vv, m_new
                    states.append((m, l, acc))
                ranges.append(_fold(states, cfg))
            if ranges:
                _, l, acc = _fold(ranges, cfg)
                o = acc / torch.where(l > 0, l, 1.0)[:, None]
                out[n, :, kvh * g:(kvh + 1) * g] = o.reshape(g, c, d).permute(1, 0, 2)
    return out


def _tc_inputs(int8: bool, ones: bool, seed: int = 3):
    """Exact scores (q, k in {-1, 0, 1}, q nonzero on 8 head dims, for a
    scale of 1/8, k_scale 1) over chains of up to 12 pages of 4 (shuffled
    tables, stale ids past each length, one empty sequence); V random (bf16
    values, or int8 with random v_scale) or 1 (v_scale 1)."""
    rng = np.random.default_rng(seed)
    n, c, h, hkv, d, bs, max_bt, nb = 4, 4, 4, 2, 16, 4, 12, 40
    lengths = np.array([37, 0, 45, 9])
    n_valid = np.array([4, 0, 3, 1], np.int32)
    tables = rng.integers(0, nb, size=(n, max_bt)).astype(np.int32)
    perm, o = rng.permutation(nb), 0
    for i, L in enumerate(lengths):
        tables[i, :-(-L // bs)] = perm[o:o - (-L // bs)]
        o -= -L // bs
    q = rng.integers(-1, 2, size=(n, c, h, d)).astype(np.float32)
    q[..., 8:] = 0
    k = rng.integers(-1, 2, size=(nb, bs, hkv, d))
    if int8:
        v = np.ones_like(k) if ones else rng.integers(-127, 128, size=k.shape)
        scales = (np.ones(nb, np.float32),
                  np.ones(nb, np.float32) if ones else
                  (0.002 + 0.02 * rng.random(nb)).astype(np.float32))
        arrays = (q, k.astype(np.int8), v.astype(np.int8))
    else:
        v = np.ones(k.shape) if ones else rng.normal(size=k.shape)
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        scales = None
        arrays = (q, k.astype(np.float32), v)
    return arrays + (tables, (lengths - n_valid).astype(np.int32), n_valid), scales


@pytest.mark.parametrize("ones", [False, True], ids=["exact", "ones"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_tensor_core_paged_read_arithmetic(int8, ones):
    """The tensor-core paged read's rounding points, emulated on the CPU,
    against the plain version and the Pallas kernel in interpret mode, on
    exact-score inputs with chip_smoke.py's tolerances: 2e-5 on every valid
    row (only the Q1.15 rounding of the corrections, applied per 8-key
    slice, per stream fold and per range merge, differs), 1e-5 of 1 with
    V = 1, and the empty sequence reads 0."""
    cfg = SoftmaxLUTConfig(frac_bits=3)
    arrays, scales = _tc_inputs(int8, ones)
    t_scales = None if scales is None else tuple(torch.from_numpy(s) for s in scales)
    args = _torch(*arrays)
    mine = _emulate_tc_read(*args, cfg, 1 / 8, t_scales).numpy()
    plain = attn_ops.gn_paged_attention_chunk(*args, cfg, sm_scale=1 / 8, scales=t_scales).numpy()
    pallas = np.asarray(jax_attn_ops.gn_paged_attention_chunk(
        *[jnp.asarray(a) for a in arrays], sm_scale=1 / 8, interpret=True,
        scales=None if scales is None else tuple(jnp.asarray(s) for s in scales)))
    ok = _lane_ok(4, arrays[5])
    np.testing.assert_allclose(mine[ok], plain[ok], atol=2e-5, rtol=0)
    np.testing.assert_allclose(mine[ok], pallas[ok], atol=2e-5, rtol=0)
    if ones:
        np.testing.assert_allclose(mine[ok], 1.0, atol=1e-5, rtol=0)
    assert (mine[1] == 0).all() and (plain[1] == 0).all()
