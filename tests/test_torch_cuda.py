"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in a
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: f32 as the reference's own kernel-vs-ref tests (2e-4 for the
online paged read, 1e-6 for the softmax, a few f32 ulps for the norm); the
flash attention to 2e-4 on random inputs with at most 1% of rows past it
(a Δ-grid flip, see chip_smoke.py) and to 2e-5 on exact-score inputs;
bf16 one bf16 rounding on top.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.core.luts import SoftmaxLUTConfig
from repro_torch.kernels import counters
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_attention import ref as fa_ref
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_layernorm import ref as norm_ref
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.kernels.gn_paged_attention import ref as attn_ref
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.kernels.gn_softmax import ref as sm_ref
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, generate, perplexity
from repro_torch.serve.workload import required_max_seq, seeded_requests

pytestmark = pytest.mark.cuda
BF16_REL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, atol, dtype):
    rel = BF16_REL if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rel * want.float().abs()).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("cols", [2048, 100])
def test_norm_kernel_matches_plain(cuda, cols, subtract_mean, dtype):
    g = torch.Generator(device=cuda).manual_seed(cols)
    x = (torch.randn(37, cols, generator=g, device=cuda) * 2 + 0.3).to(dtype)
    gamma = 1 + 0.1 * torch.randn(cols, generator=g, device=cuda)
    beta = 0.1 * torch.randn(cols, generator=g, device=cuda) if subtract_mean else None
    before = norm_ops.launches
    got = norm_ops.gn_layernorm(x, gamma, beta, subtract_mean=subtract_mean)
    assert norm_ops.launches == before + 1
    want = norm_ref.gn_layernorm_ref(x, gamma, beta, subtract_mean=subtract_mean)
    _close(got, want, 4e-6, dtype)


def _paged(cuda, c, bs, dtype, v_ones=False, seed=0):
    rng = np.random.default_rng(seed)
    n, h, kv, d, max_bt = 5, 8, 2, 64, 12
    lengths = rng.integers(1, max_bt * bs + 1, size=n)
    lengths[1] = 0
    n_valid = np.where(lengths > 0, np.minimum(rng.integers(1, c + 1, size=n), lengths), 0)
    nb = n * max_bt
    tables = rng.permutation(nb).reshape(n, max_bt)
    tables[:, -2:] = rng.integers(0, nb, size=(n, 2))  # stale entries
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(n, c, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(nb, bs, kv, d, generator=g, device=cuda).to(dtype)
    v = (torch.ones_like(k) if v_ones else torch.randn(nb, bs, kv, d, generator=g,
                                                       device=cuda).to(dtype))
    ints = [torch.as_tensor(a, dtype=torch.int32, device=cuda)
            for a in (tables, lengths - n_valid, n_valid)]
    lane = torch.as_tensor(np.arange(c)[None] < n_valid[:, None], device=cuda)
    return (q, k, v, *ints), lane


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 4, 16])
@pytest.mark.parametrize("bs", [4, 16])
def test_paged_attention_kernel_matches_plain(cuda, bs, c, dtype):
    args, lane = _paged(cuda, c, bs, dtype)
    before = attn_ops.launches
    got = attn_ops.gn_paged_attention_chunk(*args)
    assert attn_ops.launches == before + 1
    want = attn_ref.gn_paged_attention_chunk_ref(*args)
    _close(got[lane], want[lane], 2e-4, dtype)
    assert got[1].abs().max().item() == 0.0  # the empty sequence reads nothing


@pytest.mark.parametrize("c", [1, 16])
def test_paged_attention_kernel_sums_to_one(cuda, c):
    args, lane = _paged(cuda, c, 16, torch.float32, v_ones=True, seed=3)
    out = attn_ops.gn_paged_attention_chunk(*args)
    assert (out[lane] - 1).abs().max().item() <= 1e-5


def test_kernels_refuse_bad_inputs(cuda):
    args, _ = _paged(cuda, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        attn_ops.gn_paged_attention_chunk(args[0], args[1].half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        attn_ops.gn_paged_attention_chunk(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError):
        norm_ops.gn_rmsnorm(torch.randn(3, 8, device=cuda).half())


def test_engine_on_cuda_launches_the_kernels_every_tick(cuda):
    cfg = reduce_config(get_config("internlm2-1.8b"))
    model = make_model(cfg)
    reqs = seeded_requests(cfg.vocab, 5, 4, 20, 4, seed=1)
    eng = ContinuousEngine(model, model.init(0, cuda), num_slots=2,
                           max_seq=required_max_seq(reqs), chunk=4, device=cuda)
    attn0, norm0, plain0 = attn_ops.launches, norm_ops.launches, attn_ref.cuda_calls
    eng.run(reqs)
    ticks = eng.metrics()["model_ticks"]
    assert attn_ops.launches - attn0 == cfg.n_layers * ticks
    assert norm_ops.launches - norm0 == (2 * cfg.n_layers + 1) * ticks
    assert attn_ref.cuda_calls == plain0
    assert eng.pool.blocks_in_use == 0


def _masked_logits(cuda, rows, cols, seed, scale=3.0):
    """Random logits with a causal-style masked tail of -1e30 on every row
    but the last (row r keeps its first (r % cols) + 1 columns)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, cols, generator=g, device=cuda) * scale
    keep = torch.arange(cols, device=cuda)[None] <= (torch.arange(rows, device=cuda) % cols)[:, None]
    keep[-1] = True
    return torch.where(keep, x, -1e30), keep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(37, 7), (300, 100), (64, 1024), (128, 1056), (5, 3000)])
def test_softmax_kernel_matches_plain(cuda, rows, cols, dtype):
    """Register path (<= 2048 columns) and the wide-row path."""
    x, keep = _masked_logits(cuda, rows, cols, seed=cols)
    x = x.to(dtype)
    before = sm_ops.launches
    got = sm_ops.gn_softmax(x)
    assert sm_ops.launches == before + 1 and got.dtype == dtype
    want = sm_ref.gn_softmax_ref(x)
    _close(got, want, 1e-6, dtype)
    assert (got[~keep] == 0).all()
    if dtype == torch.float32:
        assert (got.double().sum(-1) - 1).abs().max().item() <= 2e-6


@pytest.mark.parametrize("frac_bits,delta_scale", [(0, 1.0), (3, 1.0), (4, 0.5)])
def test_softmax_kernel_cfg_sweep(cuda, frac_bits, delta_scale):
    cfg = SoftmaxLUTConfig(frac_bits, delta_scale=delta_scale)
    x, _ = _masked_logits(cuda, 200, 333, seed=frac_bits, scale=8.0)
    _close(sm_ops.gn_softmax(x, cfg), sm_ref.gn_softmax_ref(x, cfg), 1e-6, torch.float32)


def _attn_inputs(cuda, shape, dtype, seed, exact=False, v_ones=False):
    b, h, hkv, sq, sk, d = shape
    g = torch.Generator(device=cuda).manual_seed(seed)

    def draw(*s):
        if exact:  # q, k in {-1, 0, 1}: with scale 1/8 every score is exact
            return torch.randint(-1, 2, s, generator=g, device=cuda).float()
        return torch.randn(*s, generator=g, device=cuda)

    q, k = draw(b, h, sq, d), draw(b, hkv, sk, d)
    if exact:
        q[..., 8:] = 0
    v = torch.ones(b, hkv, sk, d, device=cuda) if v_ones else torch.randn(
        b, hkv, sk, d, generator=g, device=cuda)
    return [t.to(dtype) for t in (q, k, v)]


ATTN_SHAPES = [  # (B, H, Hkv, Sq, Sk, D)
    (1, 2, 2, 128, 128, 64), (2, 4, 2, 200, 200, 64), (1, 8, 1, 64, 256, 32),
    (1, 2, 2, 100, 100, 80), (2, 16, 8, 77, 77, 128), (1, 4, 4, 33, 33, 16),
    (1, 2, 1, 20, 20, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_attention_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=sum(shape))
    before = fa_ops.launches
    got = fa_ops.gn_attention(q, k, v, causal=causal)
    assert fa_ops.launches == before + 1
    want = fa_ref.gn_attention_ref(q, k, v, causal=causal)
    rel = BF16_REL if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs() - (2e-4 + rel * want.float().abs())
    bad_rows = (err > 0).any(-1).sum().item()
    assert bad_rows <= 0.01 * got.numel() // got.shape[-1], bad_rows
    # exact scores: no Δ flip is possible, every row agrees to the online
    # corrections' Q1.15 rounding
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=1, exact=True)
    _close(fa_ops.gn_attention(q, k, v, causal=causal, sm_scale=1 / 8),
           fa_ref.gn_attention_ref(q, k, v, causal=causal, sm_scale=1 / 8), 2e-5, dtype)
    q, k, v = _attn_inputs(cuda, shape, torch.float32, seed=2, v_ones=True)
    assert (fa_ops.gn_attention(q, k, v, causal=causal) - 1).abs().max().item() <= 1e-5


def test_new_kernels_refuse_bad_inputs(cuda):
    q, k, v = _attn_inputs(cuda, (1, 4, 2, 8, 8, 16), torch.float32, seed=0)
    with pytest.raises(TypeError):
        fa_ops.gn_attention(q, k.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.gn_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.gn_attention(*_attn_inputs(cuda, (1, 2, 2, 8, 8, 288), torch.float32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        sm_ops.gn_softmax(torch.randn(8, 6, device=cuda).t())
    with pytest.raises(TypeError):
        sm_ops.gn_softmax(torch.randn(3, 8, device=cuda).half())


def test_static_path_on_cuda_launches_the_kernels(cuda):
    """generate: one softmax launch per layer at prefill and per decode step;
    perplexity: one flash-attention launch per layer; no plain version runs
    on a CUDA tensor."""
    cfg = reduce_config(get_config("internlm2-1.8b"))
    model = make_model(cfg)
    params = model.prepare(model.init(0, cuda), cuda)
    tokens = torch.randint(0, cfg.vocab, (3, 12), device=cuda)
    counters.reset()
    out = generate(model, params, {"tokens": tokens}, ServeConfig(max_new_tokens=5))
    ppl = perplexity(model, params, {"tokens": out})
    L = cfg.n_layers
    assert counters.launch_counts() == {"gn_rmsnorm": (2 * L + 1) * (5 + 2),
                                        "gn_paged_attention": 0,
                                        "gn_softmax": L * (1 + 5), "gn_attention": L}
    assert not any(counters.plain_cuda_calls().values())
    assert np.isfinite(ppl) and out.shape == (3, 17)
