"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in a
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: f32 as the reference's own kernel-vs-ref tests (2e-4 for the
online paged read, a few f32 ulps for the norm); bf16 one bf16 rounding
on top.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_layernorm import ref as norm_ref
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.kernels.gn_paged_attention import ref as attn_ref
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine
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
