"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in a
fixture, never at import).  Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: f32 as the reference's own kernel-vs-ref tests (2e-4 for the
online paged read, 1e-6 for the softmax, a few f32 ulps for the norm); the
flash attention to 2e-4 on random inputs with at most 1% of rows past it
(a Δ-grid flip, see chip_smoke.py), to 2e-5 on exact-score inputs and to
1e-5 of 1 with V = 1, in the dtype under test (bf16: the tensor-core
design; f32: the CUDA-core design); bf16 one bf16 rounding on top.  The
softmax shapes cover its layouts (1 to 256 threads a row, as many chunks a
thread as the row needs, and the three-pass wide rows), picked on both
sides of every switch and each one forced, and rows off a 16-byte boundary;
its fused score entry equals the chain of scale, cast, mask, the softmax
kernel and cast bit for bit at every call site's shape, over strided
scores and broadcast masks; the norm's shapes
cover its three layouts, picked and forced, and its fused residual add,
held bit for bit to the eager add and to the unfused kernel on the sum.
The paged read's int8 mode keeps the fp mode's tolerances; ``paged_quant_write`` on the card equals the CPU bit for
bit.  The sampler's hash words on the card equal the CPU's bit for bit; the
GN sentinels on the card stay silent on a clean run and flag a V-tile fault
within one tick, K tiles too; the paged kernel's rows are finite where its
plain version's are over a NaN or Inf K or V tile, and its per-row flags of
a nonfinite live score equal the plain version's (fp and int8 arenas).  The
prefix cache and preemption on the card: a COW fork and a spill restore bit
for bit (fp and int8, in place), the paged read over tables that share
leading blocks and hold a forked tail against its plain version, and graphed
ticks right after forks and restores bitwise the eager ones.  The MLA and
MoE families: the paged read at llama4-scout's group of 5 in both designs
(fp and int8), the norm at MLA's latent widths, the softmax on router
rows, graphed MLA ticks bitwise the eager ones (fp and int8 latent arenas),
and the MoE routing on the card equal to the CPU's.  The slab pool and
sliding windows: the flash kernel's window band in both designs against the
plain version (a window past Sk bitwise the causal kernel), graphed slab
ticks bitwise the eager ones (dense, MLA, mixtral with its ring wrapped) and
equal to the CPU's at f32, and snapshots restored into an engine with
captured graphs draining bitwise by replay (paged and slab).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.core.gn_softmax import gn_softmax as core_gn_softmax
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
from repro_torch.models import attention as t_attn
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import (ContinuousEngine, ServeConfig, generate, perplexity,
                                      static_reference)
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import counter_bits, gumbel
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import (required_max_seq, seeded_requests,
                                        shared_prefix_requests, sla_requests)

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


def _norm_inputs(cuda, rows, cols, dtype, subtract_mean, seed=None):
    g = torch.Generator(device=cuda).manual_seed(cols if seed is None else seed)
    x = (torch.randn(rows, cols, generator=g, device=cuda) * 2 + 0.3).to(dtype)
    gamma = 1 + 0.1 * torch.randn(cols, generator=g, device=cuda)
    beta = 0.1 * torch.randn(cols, generator=g, device=cuda) if subtract_mean else None
    return x, gamma, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("cols", [2048, 100, 7168])
@pytest.mark.parametrize("rows", [8, 37, 128, 8448])
def test_norm_kernel_matches_plain(cuda, rows, cols, subtract_mean, dtype):
    """The kernel's own pick of layout: one chunk a thread over up to 256
    threads for few rows, two for many (8448 rows), a warp for rows of 100;
    bf16 rows of 100 start off a 16-byte boundary every other row (the
    scalar edge)."""
    x, gamma, beta = _norm_inputs(cuda, rows, cols, dtype, subtract_mean)
    before = norm_ops.launches
    got = norm_ops.gn_layernorm(x, gamma, beta, subtract_mean=subtract_mean)
    assert norm_ops.launches == before + 1
    want = norm_ref.gn_layernorm_ref(x, gamma, beta, subtract_mean=subtract_mean)
    _close(got, want, 4e-6, dtype)


# rows of 1001 start at every offset mod 16 (bf16 and f32): the scalar edge
# and gamma loaded element by element where gamma + head is off 16 bytes
NORM_LAYOUT_SHAPES = [(8, 2048), (37, 100), (300, 2048), (1200, 7), (64, 7168), (5, 20000),
                      (2000, 1000), (300, 1001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("rows,cols", NORM_LAYOUT_SHAPES)
def test_norm_kernel_layouts_match_plain(cuda, rows, cols, subtract_mean, dtype):
    """Each layout forced on every shape it holds (a group of G threads up
    to 8 G 16-byte chunks a row, the stream layout always), against the
    plain version; a layout a row does not fit is refused; the fused entry's
    y equals the unfused kernel's on s bit for bit in every layout."""
    x, gamma, beta = _norm_inputs(cuda, rows, cols, dtype, subtract_mean)
    r, _, _ = _norm_inputs(cuda, rows, cols, dtype, False, seed=cols + 2)
    want = norm_ref.gn_layernorm_ref(x, gamma, beta, subtract_mean=subtract_mean)
    chunks = -(-cols // (16 // x.element_size()))
    holds = {name: g == 0 or chunks <= 8 * g for name, g in norm_ops.LAYOUTS.items()}
    for name, fits in holds.items():
        if not fits:
            with pytest.raises(RuntimeError, match="CUDA error"):
                norm_ops.gn_layernorm(x, gamma, beta, subtract_mean=subtract_mean, layout=name)
            continue
        got = norm_ops.gn_layernorm(x, gamma, beta, subtract_mean=subtract_mean, layout=name)
        _close(got, want, 4e-6, dtype)
        s, y = norm_ops.gn_add_layernorm(x, r, gamma, beta, subtract_mean=subtract_mean,
                                         layout=name)
        assert torch.equal(s, x + r), name
        assert torch.equal(y, norm_ops.gn_layernorm(s, gamma, beta, subtract_mean=subtract_mean,
                                                    layout=name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("rows,cols", [(8, 2048), (128, 2048), (8448, 2048), (128, 7168),
                                       (37, 100)])
def test_fused_add_norm_is_the_add_then_the_kernel(cuda, rows, cols, subtract_mean, dtype):
    """The fused entry on the card: s equals the eager x + r and y the
    unfused kernel's output on s, bit for bit, one launch counted in both
    counters; y within the norm's tolerance of the plain version."""
    x, gamma, beta = _norm_inputs(cuda, rows, cols, dtype, subtract_mean, seed=cols + 1)
    r, _, _ = _norm_inputs(cuda, rows, cols, dtype, False, seed=cols + 2)
    before = (norm_ops.launches, norm_ops.launches_fused, norm_ref.cuda_calls)
    s, y = norm_ops.gn_add_layernorm(x, r, gamma, beta, subtract_mean=subtract_mean)
    assert (norm_ops.launches, norm_ops.launches_fused, norm_ref.cuda_calls) == (
        before[0] + 1, before[1] + 1, before[2])
    assert s.dtype == y.dtype == dtype
    assert torch.equal(s, x + r)
    assert torch.equal(y, norm_ops.gn_layernorm(s, gamma, beta, subtract_mean=subtract_mean))
    _close(y, norm_ref.gn_layernorm_ref(x + r, gamma, beta, subtract_mean=subtract_mean),
           4e-6, dtype)
    if not subtract_mean:
        s2, y2 = norm_ops.gn_add_rmsnorm(x, r, gamma)
        assert torch.equal(s2, s) and torch.equal(y2, y)


@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("rows,cols", [(8, 2048), (128, 2048), (8448, 2048), (64, 7168)])
def test_norm_kernel_sigma_matches_plain(cuda, rows, cols, subtract_mean):
    """The guarantee itself: with gamma = 1 and beta = 0, each row's sigma
    (LN mode) or RMS (RMS mode) of the kernel's output equals the plain
    version's to 1e-6 at f32."""
    x, _, _ = _norm_inputs(cuda, rows, cols, torch.float32, subtract_mean)
    gamma = torch.ones(cols, device=cuda)
    beta = torch.zeros(cols, device=cuda) if subtract_mean else None

    def sigma(y):
        y = y.double()
        if subtract_mean:
            y = y - y.mean(-1, keepdim=True)
        return y.square().mean(-1).sqrt()

    got = sigma(norm_ops.gn_layernorm(x, gamma, beta, subtract_mean=subtract_mean))
    want = sigma(norm_ref.gn_layernorm_ref(x, gamma, beta, subtract_mean=subtract_mean))
    assert (got - want).abs().max().item() <= 1e-6


def test_norm_kernel_takes_rows_of_another_alignment_than_out(cuda):
    """x starting 4 bytes past a 16-byte boundary (y is aligned): the stream
    layout, in both entries."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for rows, cols in ((128, 2048), (8448, 2048)):
        flat = torch.randn(rows * cols + 1, generator=g, device=cuda)
        x = flat[1:].view(rows, cols)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        assert norm_ops.layout(x) == "stream"
        gamma = torch.ones(cols, device=cuda)
        _close(norm_ops.gn_rmsnorm(x, gamma), norm_ref.gn_layernorm_ref(x, gamma, None,
                                                                          subtract_mean=False),
               4e-6, torch.float32)
        r = torch.randn(rows, cols, generator=g, device=cuda)
        s, y = norm_ops.gn_add_rmsnorm(x, r, gamma)
        assert torch.equal(s, x + r) and torch.equal(y, norm_ops.gn_rmsnorm(s, gamma, layout="stream"))


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


def _quantized(args, seed, exact=False):
    """The fp case's arenas replaced by int8 ones with per-block f32 scales
    (``exact``: k in {-1, 0, 1} at scale 1, so every score stays exact)."""
    q, k, v, *ints = args
    g = torch.Generator(device=q.device).manual_seed(seed)
    nb = k.shape[0]
    if exact:
        k8 = torch.randint(-1, 2, k.shape, generator=g, device=q.device).to(torch.int8)
        ks = torch.ones(nb, device=q.device)
    else:
        k8 = torch.randint(-127, 128, k.shape, generator=g, device=q.device).to(torch.int8)
        ks = 0.002 + 0.02 * torch.rand(nb, generator=g, device=q.device)
    v8 = torch.randint(-127, 128, k.shape, generator=g, device=q.device).to(torch.int8)
    vs = 0.002 + 0.02 * torch.rand(nb, generator=g, device=q.device)
    return (q, k8, v8, *ints), (ks, vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 16])
def test_paged_attention_int8_kernel_matches_plain(cuda, c, dtype):
    args, lane = _paged(cuda, c, 16, dtype)
    args, scales = _quantized(args, seed=c)
    before = (attn_ops.launches, attn_ops.launches_int8)
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    assert (attn_ops.launches, attn_ops.launches_int8) == (before[0], before[1] + 1)
    want = attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)
    # random scores: the attention kernels' 1% row budget, and at least one
    # row (a Δ-grid flip moves a row past 2e-4, see chip_smoke.py; the C=1
    # case has 32 rows)
    rel = BF16_REL if dtype == torch.bfloat16 else 0.0
    err = (got[lane].float() - want[lane].float()).abs() - (2e-4 + rel * want[lane].float().abs())
    rows = err.shape[0] * err.shape[1]
    assert (err > 0).any(-1).sum().item() <= max(1, 0.01 * rows)
    assert got[1].abs().max().item() == 0.0
    # exact scores: q and k in {-1, 0, 1}, scale 1, sm_scale 1/8
    ex, _ = _paged(cuda, c, 16, dtype, seed=7)
    q = torch.randint(-1, 2, ex[0].shape, device=cuda).to(dtype)
    q[..., 8:] = 0
    ex, ex_scales = _quantized((q, *ex[1:]), seed=c + 1, exact=True)
    _close(attn_ops.gn_paged_attention_chunk(*ex, sm_scale=1 / 8, scales=ex_scales)[lane],
           attn_ref.gn_paged_attention_chunk_ref(*ex, sm_scale=1 / 8, scales=ex_scales)[lane],
           2e-5, dtype)
    # V = 1 through int8 blocks: every valid row sums to one
    ones = (args[0].float(), args[1], torch.ones_like(args[2]), *args[3:])
    out = attn_ops.gn_paged_attention_chunk(*ones, scales=(scales[0], torch.ones_like(scales[1])))
    assert (out[lane] - 1).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [4, 16])
def test_quant_write_on_card_equals_cpu(cuda, bs, dtype):
    nb, kv, d = 12, 8, 128
    rng = np.random.default_rng(bs)
    arena = torch.zeros((nb + 1) * bs, kv, d, dtype=torch.int8)
    scale = torch.zeros(nb + 1)
    arena_d, scale_d = arena.to(cuda), scale.to(cuda)
    for tick in range(3):
        dest = torch.from_numpy(rng.choice(nb * bs, 20, replace=False))
        dest[-3:] = nb * bs  # dropped lanes go to the sink
        vals = torch.from_numpy(rng.normal(size=(20, kv, d)) * (1 + tick)).float().to(dtype)
        t_attn.paged_quant_write(arena, scale, vals, dest, bs)
        t_attn.paged_quant_write(arena_d, scale_d, vals.to(cuda), dest.to(cuda), bs)
        assert torch.equal(arena_d[:nb * bs].cpu(), arena[:nb * bs])
        assert torch.equal(scale_d[:nb].cpu().view(torch.int32), scale[:nb].view(torch.int32))


def test_kernels_refuse_bad_inputs(cuda):
    args, _ = _paged(cuda, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        attn_ops.gn_paged_attention_chunk(args[0], args[1].half(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        attn_ops.gn_paged_attention_chunk(args[0].transpose(1, 2), *args[1:])
    q8, scales = _quantized(args, seed=0)
    with pytest.raises(TypeError):  # int8 arenas without scales, fp arenas with them
        attn_ops.gn_paged_attention_chunk(*q8)
    with pytest.raises(TypeError):
        attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    with pytest.raises(ValueError, match="k_scale"):
        attn_ops.gn_paged_attention_chunk(*q8, scales=(scales[0][:-1], scales[1]))
    with pytest.raises(ValueError, match="v_scale"):
        attn_ops.gn_paged_attention_chunk(*q8, scales=(scales[0], scales[1].double()))
    with pytest.raises(TypeError):
        norm_ops.gn_rmsnorm(torch.randn(3, 8, device=cuda).half())
    with pytest.raises(TypeError):
        norm_ops.gn_add_rmsnorm(*(torch.zeros(3, 8, device=cuda).half(),) * 2)
    x = torch.zeros(3, 8, device=cuda)
    with pytest.raises(ValueError, match="alike"):
        norm_ops.gn_add_rmsnorm(x, x.cpu())


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_engine_on_cuda_launches_the_kernels_every_tick(cuda, kv_dtype):
    cfg = reduce_config(get_config("internlm2-1.8b"))
    model = make_model(cfg)
    reqs = seeded_requests(cfg.vocab, 5, 4, 20, 4, seed=1)
    eng = ContinuousEngine(model, model.init(0, cuda), num_slots=2,
                           max_seq=required_max_seq(reqs), chunk=4, device=cuda,
                           kv_dtype=kv_dtype)
    counters.reset()
    eng.run(reqs)
    ticks, L = eng.metrics()["model_ticks"], cfg.n_layers
    launches = counters.launch_counts()
    mode = "gn_paged_attention_int8" if kv_dtype == "int8" else "gn_paged_attention"
    other = "gn_paged_attention" if kv_dtype == "int8" else "gn_paged_attention_int8"
    assert launches[mode] == L * ticks and launches[other] == 0
    # 2L + 1 norms a tick, and with the GN sentinels (on by default) the
    # head's σ probe, the model's own norm with unit gamma
    assert eng.sentinels
    assert launches["gn_rmsnorm"] == (2 * L + 2) * ticks
    assert launches["gn_rmsnorm_fused"] == (2 * L - 1) * ticks
    assert not any(counters.plain_cuda_calls().values())
    assert eng.pool.blocks_in_use == 0


def _greedy(device, dtype, kv_dtype="fp", static=False):
    """The reduced internlm2-1.8b config at ``dtype`` with weights from one
    CPU seed: the continuous engine's full token arrays per request on
    ``device`` (chunk 4, block 4, 2 slots), or the static oracle's."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype=dtype)
    model = make_model(cfg)
    master = model.init(0, "cpu")
    reqs = seeded_requests(cfg.vocab, 6, 4, 24, 8, seed=2)
    if static:
        return static_reference(model, model.prepare(master, device), reqs, ServeConfig())
    eng = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                           chunk=4, block_size=4, device=device, kv_dtype=kv_dtype)
    return {c.request_id: c.tokens for c in eng.run(reqs)}


def test_engine_greedy_tokens_on_card_equal_static_oracle_and_cpu(cuda):
    """At float32 the continuous engine's greedy tokens on the card equal
    the static oracle's on the card and the CPU engine's, same weights."""
    card = _greedy(cuda, "float32")
    oracle = _greedy(cuda, "float32", static=True)
    cpu = _greedy("cpu", "float32")
    for rid, toks in card.items():
        assert np.array_equal(toks, oracle[rid]), rid
        assert np.array_equal(toks, cpu[rid]), rid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_engine_on_card_keeps_the_prefix_pins_vs_fp(cuda, dtype):
    """Over the int8 pool on the card, the reference's int8-vs-fp pins
    (tests/test_serve_quant.py) hold against the fp pool's tokens on the
    card: per-request common-prefix fractions min >= 0.5, mean >= 0.7."""
    fp, q8 = _greedy(cuda, dtype), _greedy(cuda, dtype, kv_dtype="int8")
    fracs = []
    for rid, want in fp.items():
        diff = np.nonzero(want != q8[rid])[0]
        fracs.append((diff[0] if diff.size else len(want)) / len(want))
    assert min(fracs) >= 0.5, fracs
    assert float(np.mean(fracs)) >= 0.7, fracs


def _masked_logits(cuda, rows, cols, seed, scale=3.0):
    """Random logits with a causal-style masked tail of -1e30 on every row
    but the last (row r keeps its first (r % cols) + 1 columns)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, cols, generator=g, device=cuda) * scale
    keep = torch.arange(cols, device=cuda)[None] <= (torch.arange(rows, device=cuda) % cols)[:, None]
    keep[-1] = True
    return torch.where(keep, x, -1e30), keep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(37, 7), (300, 100), (64, 1024), (128, 1056), (5, 3000),
                                       (16, 2048), (3, 1500), (4500, 300), (8, 12000)])
def test_softmax_kernel_matches_plain(cuda, rows, cols, dtype):
    """Sub-warp, warp and multi-warp row groups (bf16 rows of 1500 and f32
    rows of 7 start off a 16-byte boundary) and the wide-row path (12000
    columns)."""
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


def test_softmax_kernel_takes_rows_of_another_alignment_than_out(cuda):
    """x starting 4 bytes past a 16-byte boundary (out is aligned): the
    kernel takes a layout without vector loads."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for rows, cols in ((128, 1056), (8, 3000)):
        flat = torch.randn(rows * cols + 1, generator=g, device=cuda) * 3
        x = flat[1:].view(rows, cols)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        _close(sm_ops.gn_softmax(x), sm_ref.gn_softmax_ref(x), 1e-6, torch.float32)


@pytest.mark.parametrize("frac_bits,delta_scale", [(0, 1.0), (3, 1.0), (4, 0.5)])
def test_softmax_kernel_cfg_sweep(cuda, frac_bits, delta_scale):
    cfg = SoftmaxLUTConfig(frac_bits, delta_scale=delta_scale)
    x, _ = _masked_logits(cuda, 200, 333, seed=frac_bits, scale=8.0)
    _close(sm_ops.gn_softmax(x, cfg), sm_ref.gn_softmax_ref(x, cfg), 1e-6, torch.float32)


# the layout switches (chunks of 4 columns, and up to 3 columns of a row's
# head shift): 32 chunks (sub-warp groups below), each group's reach at 3
# chunks a thread (384, 768, 1536), 8192 columns (the wide kernel above);
# the widths of the paths' rows between (the VLM's 1601)
SOFTMAX_EDGE_COLS = [16, 17, 32, 33, 128, 129, 384, 385, 768, 769, 1024, 1025, 1056, 1500, 1536,
                     1537, 1601, 2048, 2049, 4112, 8191, 8192, 8193]


def _chunks(cols: int) -> int:
    """The chunks a row of ``cols`` columns spans at its largest head shift
    (the row's offset in the output mod 4: 0, 2 or 3 columns)."""
    k = sm_ops.CHUNK_COLS
    return -(-(cols + (0 if cols % k == 0 else 2 if cols % k == 2 else k - 1)) // k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", SOFTMAX_EDGE_COLS)
def test_softmax_kernel_over_the_layout_switches(cuda, cols, dtype):
    """Each width at a few rows and at many (the wider rows at fewer), rows
    starting off 16-byte boundaries (an odd start of 1 element), against
    the plain version; the pick named by ``ops.layout`` covers the row at
    its largest head shift with no thread's chunks wholly outside it."""
    for rows in ((37, 4224) if cols <= 2049 else (700, 4224) if cols <= 4112 else (3, 300)):
        g, cpt = sm_ops.layout(cols)
        if _chunks(cols) * sm_ops.CHUNK_COLS > 8192:
            assert (g, cpt) == (0, 0)
        else:
            assert g * cpt >= _chunks(cols) and g * (cpt - 1) < _chunks(cols)
        x, keep = _masked_logits(cuda, rows, cols + 1, seed=cols + rows)
        x = x.to(dtype).reshape(-1)[1:rows * cols + 1].view(rows, cols)  # odd start
        keep = keep.reshape(-1)[1:rows * cols + 1].view(rows, cols)
        got = sm_ops.gn_softmax(x)
        _close(got, sm_ref.gn_softmax_ref(x), 1e-6, dtype)
        assert (got[~keep & keep.any(-1, keepdim=True)] == 0).all()
        if dtype == torch.float32:
            assert (got.double().sum(-1) - 1).abs().max().item() <= 2e-6


def _instances():
    """The kernel's (G, CPT) instances (csrc/gn_softmax.cuh ``launch_g``)."""
    out = [(g, 1) for g in (1, 2, 4, 8, 16, 32)]
    return out + [(g, c) for g in (32, 64, 128) for c in (2, 3)] + [(256, c) for c in range(2, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_kernel_every_instance_by_width(cuda, dtype):
    """Every instance through the narrowest and the widest row that picks
    it (the widest: 4 G CPT columns), at a row count that is not a
    multiple of its rows a block, against the plain version; every width
    of the register layouts picks an instance."""
    k = sm_ops.CHUNK_COLS
    widths = {}
    for cols in range(1, 8193):
        widths.setdefault(sm_ops.layout(cols), []).append(cols)
    assert set(widths) - {(0, 0)} == set(_instances())
    for g, cpt in _instances():
        assert max(widths[g, cpt]) == k * g * cpt
        for cols in (min(widths[g, cpt]), max(widths[g, cpt])):
            x, _ = _masked_logits(cuda, 257, cols, seed=g * 10 + cpt)
            x = x.to(dtype)
            _close(sm_ops.gn_softmax(x), sm_ref.gn_softmax_ref(x), 1e-6, dtype)


def _fused_sites(cuda):
    """(label, raw scores, mask broadcastable to them, scale) at each call
    site's full-width shape: ``_sdpa``'s static prefill and decode step
    (internlm2-1.8b, 8 kv heads x 2), the slab and the paged tick (8 slots
    x 16 lanes over 1056 columns), whisper's cross-attention (20 heads over
    1500 frames, no mask), the VLM's cross-attention (32 heads over 1601
    patches, no mask: rows off the 16-byte grid), MLA's tick (40 heads,
    (N, 1, C, T) mask)."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def raw(*shape):
        return torch.randn(*shape, generator=g, device=cuda) * 3 * 128 ** 0.5

    rows = 1040 + torch.arange(16, device=cuda)[None, :] + 0 * torch.arange(8, device=cuda)[:, None]
    tick = torch.arange(1056, device=cuda)[None, None, :] <= rows[:, :, None]
    causal = t_attn.causal_mask(1024, 1024, cuda)
    return [("sdpa-prefill", raw(2, 8, 2, 1024, 1024), causal[:, :, None], 128 ** -0.5),
            ("sdpa-decode", raw(8, 8, 2, 1, 1056),
             (torch.arange(1056, device=cuda) <= 1040)[None, None, None, None], 128 ** -0.5),
            ("slab-tick", raw(8, 8, 2, 16, 1056), tick[:, None, None], 128 ** -0.5),
            ("paged-read", raw(8, 8, 2, 16, 1056), tick[:, None, None], 128 ** -0.5),
            ("whisper-cross", raw(8, 20, 1, 16, 1500), None, 64 ** -0.5),
            ("vlm-cross", raw(8, 32, 1, 16, 1601), None, 128 ** -0.5),
            ("mla-tick", raw(8, 40, 16, 1056), tick[:, None], 128 ** -0.5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_scores_entry_is_the_chain_bitwise(cuda, dtype):
    """One launch of ``gn_softmax_scores`` against the chain it replaces
    (scale in the scores' dtype, f32 cast, where, the softmax kernel, cast),
    bit for bit, at every call site's shape; again over strided scores (a
    column slice of wider rows, leading dims permuted) and with f32
    probabilities out of bf16 scores."""
    def chain(s, scale, mask, out_dtype):
        s = (s * torch.tensor(scale, dtype=s.dtype)).float()
        if mask is not None:
            s = torch.where(mask, s, -1e30)
        return sm_ops.gn_softmax(s).to(out_dtype)

    for label, raw, mask, scale in _fused_sites(cuda):
        raw = raw.to(dtype)
        before = sm_ops.launches
        got = sm_ops.gn_softmax_scores(raw, scale, mask, dtype)
        assert sm_ops.launches == before + 1, label
        want = chain(raw, scale, mask, dtype)
        assert torch.equal(got, want), (label, (got.float() - want.float()).abs().max().item())
        assert torch.equal(sm_ops.gn_softmax_scores(raw, scale, mask, torch.float32),
                           chain(raw, scale, mask, torch.float32)), label
        if mask is not None:
            full = mask.expand(raw.shape)
            assert (got[~full & full.any(-1, keepdim=True)] == 0).all(), label
        wide = torch.cat([raw, raw[..., :5]], dim=-1)[..., 3:raw.shape[-1] + 3]  # strided rows
        assert wide.stride(-2) == raw.shape[-1] + 5
        assert torch.equal(sm_ops.gn_softmax_scores(wide, scale, mask, dtype),
                           chain(wide, scale, mask, dtype)), label
        perm = raw.transpose(0, 1).contiguous().transpose(0, 1)  # leading dims permuted
        assert not perm.is_contiguous()
        assert torch.equal(sm_ops.gn_softmax_scores(perm, scale, mask, dtype), want), label
        del raw, wide, perm
    with pytest.raises(ValueError, match="unit stride"):
        sm_ops.gn_softmax_scores(torch.zeros(4, 8, device=cuda).t(), 0.5)


def test_fused_scores_backward_on_card_is_autograd_through_the_chain(cuda):
    """The fused entry's backward on the card against autograd through the
    chain over the softmax kernel: bit for bit (bf16 scores, a causal
    mask)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    raw = (torch.randn(2, 4, 2, 64, 64, generator=g, device=cuda) * 30).bfloat16()
    w = torch.randn(raw.shape, generator=g, device=cuda)
    mask = t_attn.causal_mask(64, 64, cuda)[:, :, None]
    grads = []
    for fused in (False, True):
        x = raw.clone().requires_grad_(True)
        if fused:
            p = sm_ops.gn_softmax_scores(x, 0.125, mask, torch.bfloat16)
        else:
            s = torch.where(mask, (x * torch.tensor(0.125, dtype=x.dtype)).float(), -1e30)
            p = sm_ops.gn_softmax(s).to(torch.bfloat16)
        (p.float() * w).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


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
    (1, 2, 1, 20, 20, 256), (1, 16, 8, 1056, 1056, 128), (1, 6, 2, 50, 90, 20)]


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
    # V = 1 in the dtype under test: every row sums its p to one
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=2, v_ones=True)
    assert (fa_ops.gn_attention(q, k, v, causal=causal).float() - 1).abs().max().item() <= 1e-5


def test_attention_kernel_routes_lut_values_past_the_bf16_split(cuda):
    """bf16 with an 18-bit LUT, past the exact hi + lo split of the
    tensor-core design, runs the CUDA-core design and matches the plain
    version; f32 takes the same design."""
    cfg = SoftmaxLUTConfig(3, lut_value_bits=18)
    assert fa_ops.design(torch.bfloat16, cfg) == "cuda_core"
    q, k, v = _attn_inputs(cuda, (1, 4, 2, 40, 40, 64), torch.bfloat16, seed=4, exact=True)
    before = (fa_ops.launches, fa_ref.cuda_calls)
    got = fa_ops.gn_attention(q, k, v, cfg, causal=True, sm_scale=1 / 8)
    assert (fa_ops.launches, fa_ref.cuda_calls) == (before[0] + 1, before[1])
    _close(got, fa_ref.gn_attention_ref(q, k, v, cfg, causal=True, sm_scale=1 / 8), 2e-5,
           torch.bfloat16)
    q, k, v = (t.float() for t in (q, k, v))
    _close(fa_ops.gn_attention(q, k, v, cfg, causal=True, sm_scale=1 / 8),
           fa_ref.gn_attention_ref(q, k, v, cfg, causal=True, sm_scale=1 / 8), 2e-5,
           torch.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_kernel_routes_lut_values_past_the_bf16_split(cuda, int8):
    """The paged read in bf16 with an 18-bit LUT runs the CUDA-core design
    and matches the plain version on exact-score inputs.  q comes from a
    seeded generator; V holds int8-range values (|v| <= 127, scaled per
    block in int8 mode), so the absolute tolerance of 2e-5 set for values of
    order one scales with max |V|: near 0 the f32 sums of products with such
    values differ by more than 2e-5 in either summation order."""
    cfg = SoftmaxLUTConfig(3, lut_value_bits=18)
    assert attn_ops.design(torch.bfloat16, cfg, 64, 4 * 16) == "cuda_core"
    ex, lane = _paged(cuda, 16, 16, torch.bfloat16, seed=7)
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randint(-1, 2, ex[0].shape, generator=g, device=cuda).to(torch.bfloat16)
    q[..., 8:] = 0
    ex, scales = _quantized((q, *ex[1:]), seed=9, exact=True)  # k in {-1, 0, 1}, scale 1
    if not int8:
        ex, scales = (q, ex[1].to(torch.bfloat16), ex[2].to(torch.bfloat16), *ex[3:]), None
    v_max = (ex[2].float() if scales is None
             else ex[2].float() * scales[1][:, None, None, None]).abs().max().item()
    before = (attn_ops.launches, attn_ops.launches_int8, attn_ref.cuda_calls)
    got = attn_ops.gn_paged_attention_chunk(*ex, cfg=cfg, sm_scale=1 / 8, scales=scales)
    assert (attn_ops.launches, attn_ops.launches_int8, attn_ref.cuda_calls) == (
        before[0] + (not int8), before[1] + int8, before[2])
    want = attn_ref.gn_paged_attention_chunk_ref(*ex, cfg=cfg, sm_scale=1 / 8, scales=scales)
    _close(got[lane], want[lane], 2e-5 * v_max, torch.bfloat16)


def _lut18_f64(q, k_arena, v_arena, tables, starts, n_valid, scales, cfg):
    """The plain version's numerators (exact scores: the same LUT values the
    kernel takes) with their sum over V and the normalisation in f64."""
    n, c, h, d = q.shape
    hkv, idx = k_arena.shape[2], tables.long()
    k, v = k_arena[idx].double(), v_arena[idx].double()
    if scales is not None:
        k = k * scales[0][idx].double()[..., None, None, None]
        v = v * scales[1][idx].double()[..., None, None, None]
    k = k.reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    v = v.reshape(n, -1, hkv, d).repeat_interleave(h // hkv, dim=2)
    s = (torch.einsum("nchd,nthd->nhct", q.double(), k) / 8).float()
    col = torch.arange(s.shape[-1], device=q.device)
    rows = starts.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = ((col[None, None, :] <= rows[:, :, None])
             & (col[None, None, :] < (starts + n_valid).long()[:, None, None]))
    p = core_gn_softmax(torch.where(valid[:, None], s, -1e30), cfg).double()
    return torch.einsum("nhct,nthd->nchd", p, v)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_lut18_error_near_zero_scales_with_max_v(cuda, int8):
    """The evidence behind the tolerance of the test above, over twelve
    seeded draws of q: against an f64 sum of the same numerators, the
    kernel's error stays within 2e-5 x max |V| everywhere, and near 0 it is
    of the order of the plain f32 version's own error there (no fault: the
    online corrections' Q1.15 rounding and the f32 sums act on terms as
    large as V).  Prints one line a draw (``-s``)."""
    cfg = SoftmaxLUTConfig(3, lut_value_bits=18)
    for seed in range(100, 112):
        ex, lane = _paged(cuda, 16, 16, torch.bfloat16, seed=7)
        g = torch.Generator(device=cuda).manual_seed(seed)
        q = torch.randint(-1, 2, ex[0].shape, generator=g, device=cuda).to(torch.bfloat16)
        q[..., 8:] = 0
        ex, scales = _quantized((q, *ex[1:]), seed=9, exact=True)
        if not int8:
            ex, scales = (q, ex[1].to(torch.bfloat16), ex[2].to(torch.bfloat16), *ex[3:]), None
        v_max = (ex[2].float() if scales is None
                 else ex[2].float() * scales[1][:, None, None, None]).abs().max().item()
        got = attn_ops.gn_paged_attention_chunk(*ex, cfg=cfg, sm_scale=1 / 8, scales=scales)
        want = attn_ref.gn_paged_attention_chunk_ref(*ex, cfg=cfg, sm_scale=1 / 8,
                                                     scales=scales)
        got, want = got[lane].double(), want[lane].double()
        exact = _lut18_f64(*ex, scales, cfg)[lane]
        rel = BF16_REL * want.abs()
        near0 = exact.abs() < 0.01
        kernel_err, plain_err = (got - exact).abs(), (want - exact).abs()
        print(f"lut18 int8={int8} q seed {seed}: max|V| {v_max:.4g}; kernel vs plain past "
              f"2e-5: {int(((got - want).abs() > 2e-5 + rel).sum())} elements, past "
              f"2e-5 x max|V|: {int(((got - want).abs() > 2e-5 * v_max + rel).sum())}; near 0 "
              f"vs f64: kernel {kernel_err[near0].max().item():.3e}, plain "
              f"{plain_err[near0].max().item():.3e}")
        assert bool((kernel_err <= 2e-5 * v_max + BF16_REL * exact.abs()).all())
        assert kernel_err[near0].max().item() <= 4 * max(plain_err[near0].max().item(), 1e-6)


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
                                        "gn_rmsnorm_fused": (2 * L - 1) * (5 + 2),
                                        "gn_paged_attention": 0,
                                        "gn_paged_attention_int8": 0,
                                        "gn_softmax": L * (1 + 5), "gn_attention": L}
    assert not any(counters.plain_cuda_calls().values())
    assert np.isfinite(ppl) and out.shape == (3, 17)


# ------------------------------------------- long prompts and paged reads --
@pytest.fixture
def restore_forced_read():
    yield
    t_attn.FORCE_PAGED_READ = None


def _long_workload(device):
    """Reduced internlm2-1.8b at f32, weights from one CPU seed, and two
    requests of 2049 and 2600 prompt tokens (4 new tokens each)."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32", n_kv_heads=2)
    model = make_model(cfg)
    master = model.init(0, "cpu")
    reqs = seeded_requests(cfg.vocab, 2, 2049, 2600, 4, seed=3)
    return model, master, reqs


def test_long_prompt_generate_on_card_equals_cpu(cuda):
    """A 3072-token prompt through the flash kernel on the card and its
    plain version on the CPU: the same greedy tokens."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32", n_kv_heads=2)
    model = make_model(cfg)
    master = model.init(0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 3072)))
    counters.reset()
    out = {dev: generate(model, model.prepare(master, dev), {"tokens": tokens.to(dev)},
                         ServeConfig(max_new_tokens=4)).cpu()
           for dev in (cuda, "cpu")}
    assert counters.launch_counts()["gn_attention"] == cfg.n_layers
    assert not any(counters.plain_cuda_calls().values())
    assert torch.equal(out[cuda], out["cpu"])


def test_long_prompt_engine_on_card_equals_static_oracle_and_cpu(cuda):
    """Prompts past 2048 tokens through the graphed continuous engine on the
    card: greedy tokens equal to the static oracle on the card (the flash
    kernel's prefill) and to the CPU engine."""
    model, master, reqs = _long_workload(cuda)
    kw = {"num_slots": 2, "max_seq": required_max_seq(reqs), "chunk": 256, "block_size": 64}
    eng = ContinuousEngine(model, master, device=cuda, **kw)
    card = {c.request_id: c.tokens for c in eng.run(reqs)}
    assert eng.metrics()["transfer_guarded_ticks"] == eng.metrics()["model_ticks"]
    oracle = static_reference(model, eng.params, reqs, ServeConfig())
    cpu = {c.request_id: c.tokens for c in
           ContinuousEngine(model, master, device="cpu", **kw).run(reqs)}
    for rid, toks in card.items():
        assert np.array_equal(toks, oracle[rid]), rid
        assert np.array_equal(toks, cpu[rid]), rid


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_streamed_engine_on_card_equals_kernel_read_and_cpu(cuda, restore_forced_read,
                                                            kv_dtype):
    """The graphed engine forced to the streamed read at f32: greedy tokens
    equal to the kernel read's engine on the card and to the streamed CPU
    engine; its ticks launch the softmax kernel, one a layer, and no paged
    read."""
    kernel = _greedy(cuda, "float32", kv_dtype)
    t_attn.FORCE_PAGED_READ = "streamed"
    counters.reset()
    streamed = _greedy(cuda, "float32", kv_dtype)
    launches = counters.launch_counts()
    assert launches["gn_softmax"] > 0
    assert launches["gn_paged_attention"] == launches["gn_paged_attention_int8"] == 0
    cpu = _greedy("cpu", "float32", kv_dtype)
    for rid, toks in streamed.items():
        assert np.array_equal(toks, kernel[rid]), rid
        assert np.array_equal(toks, cpu[rid]), rid


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamed_read_on_card_bitwise_gathered(cuda, restore_forced_read, dtype, kv_dtype):
    """One fused tick on the card (prefill, decode and parked lanes, an
    11-column table, so a partial last tile): the streamed read's logits
    and arenas bit for bit the gathered read's."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype=dtype, n_kv_heads=2)
    model = make_model(cfg)
    params = model.prepare(model.init(0, "cpu"), cuda)
    rng = np.random.default_rng(7)
    ints = [torch.from_numpy(a).to(cuda) for a in (
        rng.integers(0, cfg.vocab, (4, 4)).astype(np.int32), np.array([0, 37, 18, 0], np.int32),
        np.array([4, 1, 3, 0], np.int32), rng.permutation(48)[:44].reshape(4, 11).astype(np.int32))]
    prior = torch.from_numpy(rng.normal(size=(2, cfg.n_layers, 49, 4, 2, cfg.head_dim))
                             .astype(np.float32)).to(cuda)
    got = {}
    for path in ("streamed", "gathered"):
        t_attn.FORCE_PAGED_READ = path
        cache = model.init_paged_cache(48, 4, cuda, kv_dtype)
        for i, key in enumerate(("k", "v")):
            if kv_dtype == "fp":
                cache[key].copy_(prior[i])
                continue
            for arena, scale, vals in zip(cache[key], cache[f"{key}_scale"], prior[i]):
                t_attn.paged_quant_write(arena.flatten(0, 1), scale, vals.flatten(0, 1),
                                         torch.arange(49 * 4, device=cuda), 4)
        got[path] = (model.fused_step_slots_paged(params, cache, *ints),
                     {k: v[:, :48] for k, v in cache.items()})
    assert torch.equal(got["streamed"][0], got["gathered"][0])
    for key, arena in got["gathered"][1].items():
        assert torch.equal(got["streamed"][1][key], arena), key


def test_read_path_change_after_capture_is_refused(cuda, restore_forced_read):
    """An engine that captured its graphs under the kernel read refuses to
    tick once FORCE_PAGED_READ asks for another read: no graph is replayed
    under a read it was not captured with.  A new engine takes the new read."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32")
    model = make_model(cfg)
    reqs = seeded_requests(cfg.vocab, 3, 4, 20, 4, seed=1)
    eng = ContinuousEngine(model, model.init(0, cuda), num_slots=2,
                           max_seq=required_max_seq(reqs), chunk=4, device=cuda)
    eng.run(reqs)
    assert eng.metrics()["fused_step_compilations"] > 0
    t_attn.FORCE_PAGED_READ = "streamed"
    eng.reset()
    eng.submit(reqs[0])
    counters.reset()
    with pytest.raises(RuntimeError, match="FORCE_PAGED_READ"):
        eng.step()
    assert not any(counters.launch_counts().values())
    fresh = ContinuousEngine(model, model.init(0, cuda), num_slots=2,
                             max_seq=required_max_seq(reqs), chunk=4, device=cuda)
    assert fresh.metrics()["read_path"] == "streamed"
    fresh.run(reqs)
    assert counters.launch_counts()["gn_paged_attention"] == 0


# ------------------------------------------------- sampling and sentinels --
def test_sampler_hash_on_card_equals_cpu(cuda):
    """The counter hash is integer arithmetic under 2^63: its words on the
    card equal the CPU's bit for bit at a tick's shape (8 slots, the full
    vocabulary); the Gumbel variates agree to a few f32 ulps (log)."""
    streams = torch.tensor([0, 3, 17, 2**40 + 1, 5, 6, 7, 8])
    pos = torch.tensor([0, 1, 1000, 2**33, 5, 6, 7, 92543])
    cpu = counter_bits(11, streams, pos, 92544)
    card = counter_bits(11, streams.to(cuda), pos.to(cuda), 92544)
    assert torch.equal(card.cpu(), cpu)
    g_cpu, g_card = gumbel(cpu), gumbel(card).cpu()
    assert bool(((g_card - g_cpu).abs() <= 4e-6 * g_cpu.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_sampled_engine_graphed_equals_eager_and_replays(cuda, kv_dtype):
    """At T = 0.7 the graphed engine (sentinels on) draws the eager tick's
    tokens on the card, bit for bit, and a reset replays them."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32")
    model = make_model(cfg)
    master = model.init(0, "cpu")
    reqs = seeded_requests(cfg.vocab, 6, 4, 40, 8, seed=2)

    def run(eager):
        eng = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                               cfg=ServeConfig(temperature=0.7, seed=3), chunk=4, block_size=4,
                               kv_dtype=kv_dtype, device=cuda)
        if eager:
            eng.shards[0]._graphs = None
        return eng, {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}

    eng, graphed = run(False)
    assert eng.metrics()["transfer_guarded_ticks"] == eng.metrics()["model_ticks"]
    assert run(True)[1] == graphed
    eng.reset()
    assert {c.request_id: c.tokens.tolist() for c in eng.run(reqs)} == graphed
    greedy = _greedy(cuda, "float32", kv_dtype)
    assert any(graphed[i] != greedy[i].tolist() for i in graphed)


def _poison(args, leaf: str, value: float):
    """Poison one block of sequence 0's live chain (its first table entry)."""
    q, k, v, tables, starts, n_valid = args
    k, v = k.clone(), v.clone()
    blk = int(tables[0, 0])
    (k if leaf == "k" else v)[blk] = value
    return (q, k, v, tables, starts, n_valid)


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
@pytest.mark.parametrize("leaf", ["k", "v"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_finite_where_plain_is_over_poisoned_tiles(cuda, dtype, leaf, value):
    """Per valid row, the kernel's output is finite exactly where its plain
    version's is (both designs: f32 on the CUDA cores, bf16 on the tensor
    cores), over a NaN or Inf K or V tile in a live chain; the rows that
    read no poisoned block agree within the kernel's tolerance; the flags
    of a nonfinite live score equal the plain version's on every valid row
    (set on the rows that read the K tile, nowhere for a V tile)."""
    args, lane = _paged(cuda, 16, 16, dtype)
    args = _poison(args, leaf, value)
    got, flags = attn_ops.gn_paged_attention_chunk(*args, nonfinite=True)
    want, want_flags = attn_ref.gn_paged_attention_chunk_ref(*args, nonfinite=True)
    assert torch.equal(flags[lane], want_flags[lane])
    assert bool(flags[lane].any()) == (leaf == "k")
    again = attn_ops.gn_paged_attention_chunk(*args)  # the output, bit for bit, without flags
    assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    fin_got = torch.isfinite(got.float()).flatten(2).all(-1)[lane]
    fin_want = torch.isfinite(want.float()).flatten(2).all(-1)[lane]
    print(f"{dtype} {leaf} {value}: finite rows kernel {int(fin_got.sum())}, plain "
          f"{int(fin_want.sum())} of {int(lane.sum())}")
    assert torch.equal(fin_got, fin_want)
    blk = int(args[3][0, 0])
    reads = [(args[3][i, :-(-int(args[4][i] + args[5][i]) // 16)] == blk).any().item()
             for i in range(args[0].shape[0])]
    clean = torch.tensor([not r for r in reads], device=cuda)[:, None] & lane
    _close(got[clean], want[clean], 2e-4, dtype)


@pytest.mark.parametrize("c", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_flags_nonfinite_scales_int8(cuda, dtype, c):
    """int8 arenas: a NaN or +Inf k_scale turns that block's scores
    nonfinite; per valid row the kernel's flags equal the plain version's,
    both designs, one chain range and many."""
    args, lane = _paged(cuda, c, 16, dtype)
    args, (ks, vs) = _quantized(args, seed=5)
    tables = args[3]
    ks = ks.clone()
    ks[int(tables[0, 0])] = float("nan")
    ks[int(tables[2, 0])] = float("inf")
    got, flags = attn_ops.gn_paged_attention_chunk(*args, scales=(ks, vs), nonfinite=True)
    _, want = attn_ref.gn_paged_attention_chunk_ref(*args, scales=(ks, vs), nonfinite=True)
    assert torch.equal(flags[lane], want[lane]) and bool(flags[lane].any())


def _sentinel_engine(cuda, dtype, **kw):
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype=dtype)
    model = make_model(cfg)
    reqs = [Request(tokens=r.tokens, max_new_tokens=6) for r in
            seeded_requests(cfg.vocab, 3, 5, 9, 6, seed=0)]
    return ContinuousEngine(model, model.init(0, "cpu"), num_slots=2, max_seq=64, chunk=4,
                            device=cuda, **kw), reqs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_sentinels_on_card_silent_when_clean(cuda, dtype, kv_dtype):
    eng, reqs = _sentinel_engine(cuda, dtype, kv_dtype=kv_dtype)
    eng.run(reqs)
    m = eng.metrics()
    assert m["sentinels"] and m["sentinel_checks"] > 0
    assert m["sentinel_violations"] == m["quarantined_blocks"] == m["fallbacks"] == 0
    assert m["transfer_guarded_ticks"] == m["model_ticks"]


@pytest.mark.parametrize("kind", ["nan_tile", "inf_tile"])
def test_sentinels_on_card_flag_v_tiles_and_recover(cuda, kind):
    """The graphed kernel read on the card at f32: every V-tile fault is
    flagged within one tick of its injection, its block quarantined and
    scrubbed, and the recovered tokens equal the fault-free run's; the same
    for K-tile faults, which the read's per-row flag carries to the probe."""
    eng, reqs = _sentinel_engine(cuda, "float32")
    clean = {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}
    eng.reset()
    inj = FaultInjector(eng, seed=1, leaves=("v",))
    for r in reqs:
        eng.submit(r)
    records = []
    while eng.step():
        if len(records) < 2 and (rec := inj.inject(kind)) is not None:
            records.append(rec)
    flagged = [e[1] for e in eng.event_log if e[0] == "fault"]
    assert records and all(any(0 <= s - r.step <= 1 for s in flagged) for r in records)
    assert any(r.block in eng.pool.quarantined for r in records)
    assert {c.request_id: c.tokens.tolist() for c in eng.completions} == clean
    eng.reset()
    inj = FaultInjector(eng, seed=1, leaves=("k",))
    for r in reqs:
        eng.submit(r)
    k_records = []
    while eng.step():
        if len(k_records) < 2 and (rec := inj.inject(kind)) is not None:
            k_records.append(rec)
    print(f"K-tile {kind} on the card: {len(k_records)} injected, "
          f"{eng.metrics()['sentinel_violations']} violations")
    flagged = [e[1] for e in eng.event_log if e[0] == "fault"]
    assert k_records and all(any(0 <= s - r.step <= 1 for s in flagged) for r in k_records)
    assert {c.request_id: c.tokens.tolist() for c in eng.completions} == clean


# ------------------------------------------ prefix cache and preemption --
def _filled_pool(cuda, kv_dtype, seed):
    """A pool on the card whose real blocks hold random values of each
    leaf's dtype (int8 arenas, f32 scales), so a moved block shows."""
    model = make_model(reduce_config(get_config("internlm2-1.8b"), dtype="float32"))
    pool = BlockPagedKVPool(model, num_slots=3, max_seq=32, block_size=4, num_blocks=12,
                            device=cuda, kv_dtype=kv_dtype)
    g = torch.Generator(device=cuda).manual_seed(seed)
    for leaf in pool.caches[0].values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=cuda))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=g, device=cuda) + 0.01)
    return pool


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_fork_and_spill_restore_bitwise_on_card(cuda, kv_dtype):
    """An attach-time fork copies its source block bit for bit in every leaf
    and touches no other block; a spill restored into another chain is bit
    for bit; both write the arenas and scales in place."""
    pool = _filled_pool(cuda, kv_dtype, seed=5)
    pool.attach_prefix_cache(PrefixCache(4))
    ptrs = {k: v.data_ptr() for k, v in pool.caches[0].items()}
    before = {k: v.clone() for k, v in pool.caches[0].items()}
    s0 = pool.allocate(reserve_tokens=16)
    pool.ensure(s0, 16)
    chain0 = pool.chain_of(s0)
    tokens = np.arange(14, dtype=np.int32)
    pool.prefix_cache.insert(tokens, chain0[:4])
    pool.free(s0)
    hit = pool.prefix_cache.lookup(tokens)
    s1 = pool.allocate(reserve_tokens=16, prefix=hit)
    pool.attach_prefix(s1, hit)
    dst = pool.chain_of(s1)[3]
    for k, leaf in pool.caches[0].items():
        assert torch.equal(leaf[:, dst], before[k][:, hit.tail_src]), k
        keep = torch.arange(leaf.shape[1], device=cuda) != dst
        assert torch.equal(leaf[:, keep], before[k][:, keep]), k
    pool.ensure(s1, 16)
    chain1 = pool.chain_of(s1)
    values = {k: v[:, chain1].clone() for k, v in pool.caches[0].items()}
    payload = pool.extract_blocks(s1)
    assert payload["len"] == 4 and all(t.device.type == "cpu" for t in payload["layers"].values())
    pool.free(s1)
    hold = pool.allocate(reserve_tokens=16)
    pool.ensure(hold, 16)
    s2 = pool.allocate(reserve_tokens=16)
    pool.ensure(s2, 16)
    chain2 = pool.chain_of(s2)
    assert chain2 != chain1
    pool.restore_blocks(s2, payload)
    for k, leaf in pool.caches[0].items():
        assert torch.equal(leaf[:, chain2], values[k]), k
    assert {k: v.data_ptr() for k, v in pool.caches[0].items()} == ptrs


def _aliased(cuda, c, dtype, seed=0):
    """Tables whose lanes share leading physical blocks: lanes 0-4 read one
    6-block prefix; lane 1 continues through a forked copy (another id, the
    same contents) of lane 0's partially filled block 6; lanes 5-7 own their
    chains; stale entries past every length."""
    rng = np.random.default_rng(seed)
    n, h, kv, d, bs, max_bt = 8, 8, 2, 64, 16, 12
    nb = 64
    perm = rng.permutation(nb)
    shared, rest = list(perm[:6]), iter(perm[6:])
    tables = rng.integers(0, nb, size=(n, max_bt))
    lengths = np.zeros(n, np.int64)
    for i in range(n):
        own = [] if i >= 5 else list(shared)
        need = int(rng.integers(7, max_bt + 1))
        own += [next(rest) for _ in range(need - len(own))]
        tables[i, :need] = own
        lengths[i] = (need - 1) * bs + int(rng.integers(1, bs + 1))
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(n, c, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(nb, bs, kv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(nb, bs, kv, d, generator=g, device=cuda).to(dtype)
    fork = int(tables[1, 6])
    k[fork], v[fork] = k[tables[0, 6]], v[tables[0, 6]]
    lengths[1] = 6 * bs + int(rng.integers(2, bs))  # inside the forked block
    tables[1, 7:] = rng.integers(0, nb, size=max_bt - 7)
    n_valid = np.minimum(rng.integers(1, c + 1, size=n), lengths)
    ints = [torch.as_tensor(a, dtype=torch.int32, device=cuda)
            for a in (tables, lengths - n_valid, n_valid)]
    lane = torch.as_tensor(np.arange(c)[None] < n_valid[:, None], device=cuda)
    return (q, k, v, *ints), lane, (int(tables[0, 6]), fork)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 16])
def test_paged_read_over_aliased_tables_matches_plain(cuda, c, dtype, int8):
    """The prefix cache's tables (shared leading blocks, a forked tail) read
    through the kernel as through its plain version (the int8 mode with the
    fork's scale copied with its block)."""
    args, lane, (src, fork) = _aliased(cuda, c, dtype)
    scales = None
    if int8:
        args, scales = _quantized(args, seed=c)
        for t in (args[1], args[2], *scales):
            t[fork] = t[src]
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    want = attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)
    rel = BF16_REL if dtype == torch.bfloat16 else 0.0
    err = (got[lane].float() - want[lane].float()).abs() - (2e-4 + rel * want[lane].float().abs())
    rows = err.shape[0] * err.shape[1]
    assert (err > 0).any(-1).sum().item() <= max(1, 0.01 * rows)


def _engine_state(eng):
    nb = eng.pool.num_blocks
    return {"last_logits": eng.shards[0]._last_logits.clone(),
            **{k: v[:, :nb].clone() for k, v in eng.pool.caches[0].items()}}


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_graphed_ticks_after_forks_and_restores_equal_eager(cuda, kv_dtype):
    """Graphed ticks right after a COW fork (the shared-prefix workload) and
    after a spill restore (the two-class workload under priority + spill)
    give the eager tick's tokens, held logits and arenas bit for bit, every
    tick a replay; the tokens equal the CPU engine's at f32."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32")
    model = make_model(cfg)
    master = model.init(0, "cpu")
    cases = (
        (shared_prefix_requests(cfg, n_users=6, n_personas=2, system_len=12, persona_len=6,
                                user_len=5, max_new_tokens=4, stagger=7),
         {"prefix_cache": True, "num_blocks": 32}),
        (sla_requests(cfg, n_requests=8, base_len=8, rate=0.6, seed=13, max_new_interactive=4,
                      max_new_batch=8),
         {"sched": "priority", "preempt": "spill", "aging_steps": 32}),
    )
    for reqs, kw in cases:
        def run(device, eager=False):
            eng = ContinuousEngine(model, master, num_slots=2, max_seq=32, chunk=4, block_size=4,
                                   kv_dtype=kv_dtype, device=device, **kw)
            if eager:
                eng.shards[0]._graphs = None
            toks = {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}
            return eng, toks

        eng, graphed = run(cuda)
        m = eng.metrics()
        assert m["transfer_guarded_ticks"] == m["model_ticks"]
        assert m.get("prefix_forks", 0) > 0 or m["preemptions"] > 0
        state = _engine_state(eng)
        eager_eng, eager = run(cuda, eager=True)
        assert eager == graphed
        now = _engine_state(eager_eng)
        assert all(torch.equal(state[k], now[k]) for k in state)
        assert run("cpu")[1] == graphed


# ------------------------------------------------ the MLA and MoE families --
def _paged_group5(cuda, c, dtype, seed=5):
    """llama4-scout's read: 40 q heads over 8 kv heads (a group of 5), head
    dim 128, block 16; a parked lane and stale table entries."""
    rng = np.random.default_rng(seed)
    n, h, kv, d, bs, max_bt = 4, 40, 8, 128, 16, 10
    lengths = rng.integers(1, max_bt * bs + 1, size=n)
    lengths[2] = 0
    n_valid = np.where(lengths > 0, np.minimum(rng.integers(1, c + 1, size=n), lengths), 0)
    nb = n * max_bt
    tables = rng.permutation(nb).reshape(n, max_bt)
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(n, c, h, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(nb, bs, kv, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(nb, bs, kv, d, generator=g, device=cuda).to(dtype)
    ints = [torch.as_tensor(a, dtype=torch.int32, device=cuda)
            for a in (tables, lengths - n_valid, n_valid)]
    lane = torch.as_tensor(np.arange(c)[None] < n_valid[:, None], device=cuda)
    return (q, k, v, *ints), lane


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("c,design", [(16, "cuda_core"), (1, "tensor_core")])
def test_paged_read_at_group_5_matches_plain(cuda, c, design, int8):
    """80 q rows a kv head at C = 16 take the CUDA-core design (past the
    tensor cores' 64 rows), 5 at C = 1 the tensor cores; both against the
    plain version at the paged read's tolerances (1% of rows past 2e-4 for
    a Δ-grid flip, one bf16 rounding)."""
    args, lane = _paged_group5(cuda, c, torch.bfloat16)
    scales = None
    if int8:
        args, scales = _quantized(args, seed=c)
    assert attn_ops.call_design(*args[:3]) == design
    got = attn_ops.gn_paged_attention_chunk(*args, scales=scales)
    want = attn_ref.gn_paged_attention_chunk_ref(*args, scales=scales)
    err = (got[lane].float() - want[lane].float()).abs() - (2e-4 + BF16_REL
                                                             * want[lane].float().abs())
    rows = err.shape[0] * err.shape[1]
    assert (err > 0).any(-1).sum().item() <= max(1, 0.01 * rows)
    assert got[2].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [256, 768])
@pytest.mark.parametrize("rows", [8, 128])
def test_norm_kernel_at_the_mla_latent_widths(cuda, rows, cols, dtype):
    x, gamma, _ = _norm_inputs(cuda, rows, cols, dtype, False)
    _close(norm_ops.gn_rmsnorm(x, gamma),
           norm_ref.gn_layernorm_ref(x, gamma, None, subtract_mean=False), 4e-6, dtype)


@pytest.mark.parametrize("rows", [8, 128, 8192])
def test_softmax_kernel_on_router_rows(cuda, rows):
    """The MoE router's rows: 16 experts, f32 (a decode tick, a fused tick,
    a 8 x 1024 prefill)."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 16, generator=g, device=cuda) * 3
    got = sm_ops.gn_softmax(x)
    _close(got, sm_ref.gn_softmax_ref(x), 1e-6, torch.float32)
    assert (got.double().sum(-1) - 1).abs().max().item() <= 2e-6


def _family(arch, dtype="float32"):
    cfg = reduce_config(get_config(arch), dtype=dtype)
    model = make_model(cfg)
    return model, model.init(0, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_graphed_mla_ticks_equal_eager(cuda, kv_dtype, dtype):
    """The MLA engine (latent arenas, streamed read, sentinels on): every
    tick a replay, bitwise the eager tick (tokens, held logits, arenas and
    scales); at f32 the tokens equal the CPU engine's."""
    model, master = _family("minicpm3-4b", dtype)
    reqs = seeded_requests(model.cfg.vocab, 5, 5, 22, 4, 1, 0)

    def run(device, eager=False):
        eng = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs),
                               chunk=4, block_size=4, kv_dtype=kv_dtype, device=device)
        if eager:
            eng.shards[0]._graphs = None
        return eng, {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}

    eng, graphed = run(cuda)
    m = eng.metrics()
    assert m["read_path"] == "streamed" and m["transfer_guarded_ticks"] == m["model_ticks"]
    assert m["sentinel_violations"] == 0
    state = _engine_state(eng)
    eager_eng, eager = run(cuda, eager=True)
    assert eager == graphed
    now = _engine_state(eager_eng)
    assert all(torch.equal(state[k], now[k]) for k in state)
    if dtype == "float32":
        assert run("cpu")[1] == graphed


def test_moe_routing_on_the_card_equals_the_cpu(cuda):
    """A tick's hidden states (8 slots x chunk 16 = one group of 128) through
    the reduced llama4-scout router at f32: the same experts, capacity slots
    and kept choices on the card as on the CPU, the gates within 1e-6 (the
    GN softmax kernel against its plain version)."""
    from repro_torch.models import moe

    model, master = _family("llama4-scout-17b-a16e")
    p = model.prepare(master, "cpu")["layers"][0]["mlp"]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, model.cfg.d_model, generator=g)
    want = moe.route(model.cfg, p, x)
    got = moe.route(model.cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    assert got["cap"] == want["cap"]
    for key in ("idx", "slot", "keep"):
        assert torch.equal(got[key].cpu(), want[key]), key
    _close(got["gates"].cpu(), want["gates"], 1e-6, torch.float32)
    y_card = moe.apply_moe(model.cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))[0]
    _close(y_card.cpu(), moe.apply_moe(model.cfg, p, x)[0], 1e-5, torch.float32)


# ------------------------------------------------ sliding windows and slabs --
WINDOW_SHAPES = [  # (B, H, Hkv, Sq, Sk, D), window
    ((1, 12, 2, 300, 300, 128), 64), ((2, 16, 8, 333, 397, 128), 100),
    ((1, 4, 4, 200, 200, 64), 33), ((1, 6, 1, 1056, 1056, 128), 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", WINDOW_SHAPES, ids=str)
def test_attention_kernel_window_matches_plain(cuda, shape, window, dtype):
    """The flash kernel's sliding-window band in both designs against the
    plain version (the tolerances of the causal kernel), exact scores and
    V = 1 included; a window past Sk is bitwise the causal kernel."""
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=sum(shape) + window)
    got = fa_ops.gn_attention(q, k, v, causal=True, window=window)
    want = fa_ref.gn_attention_ref(q, k, v, causal=True, window=window)
    rel = BF16_REL if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs() - (2e-4 + rel * want.float().abs())
    assert (err > 0).any(-1).sum().item() <= 0.01 * got.numel() // got.shape[-1]
    assert torch.equal(fa_ops.gn_attention(q, k, v, causal=True, window=shape[4] + 3),
                       fa_ops.gn_attention(q, k, v, causal=True))
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=1, exact=True)
    _close(fa_ops.gn_attention(q, k, v, causal=True, window=window, sm_scale=1 / 8),
           fa_ref.gn_attention_ref(q, k, v, causal=True, window=window, sm_scale=1 / 8), 2e-5,
           dtype)
    q, k, v = _attn_inputs(cuda, shape, dtype, seed=2, v_ones=True)
    ones = fa_ops.gn_attention(q, k, v, causal=True, window=window)
    assert (ones.float() - 1).abs().max().item() <= 1e-5


def _slab_run(model, master, reqs, device, eager=False, **kw):
    eng = ContinuousEngine(model, master, num_slots=2, max_seq=required_max_seq(reqs), chunk=4,
                           paged=False, device=device, **kw)
    if eager:
        eng.shards[0]._graphs = None
    return eng, {c.request_id: c.tokens.tolist() for c in eng.run(reqs)}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b", "minicpm3-4b"])
def test_graphed_slab_ticks_equal_eager(cuda, arch):
    """The slab engine on the card (mixtral: its ring wraps): a graph a step
    kind, every tick a replay, bitwise the eager tick (tokens, held logits,
    slabs); the tokens equal the CPU slab engine's at f32."""
    model, master = _family(arch)
    reqs = seeded_requests(model.cfg.vocab, 5, 6, 20, 6, 1, 0)
    eng, graphed = _slab_run(model, master, reqs, cuda)
    m = eng.metrics()
    assert m["read_path"] == "slab" and m["transfer_guarded_ticks"] == m["model_ticks"]
    assert (m["fused_step_compilations"], m["decode_compilations"]) == (1, 1)
    state = {"last_logits": eng.shards[0]._last_logits.clone(),
             **{k: v.clone() for k, v in eng.pool.caches[0].items()}}
    eager_eng, eager = _slab_run(model, master, reqs, cuda, eager=True)
    assert eager == graphed
    assert torch.equal(state["last_logits"], eager_eng.shards[0]._last_logits)
    assert all(torch.equal(state[k], v) for k, v in eager_eng.pool.caches[0].items())
    assert _slab_run(model, master, reqs, "cpu")[1] == graphed


@pytest.mark.parametrize("paged", [True, False])
def test_snapshot_restores_into_captured_graphs_and_drains_bitwise(cuda, paged, tmp_path):
    """A writer snapshots after every tick; one restorer whose graphs a run
    already captured restores every snapshot in place and drains by replay,
    each drain bitwise the writer's (completions, finish steps, events)."""
    model, master = _family("internlm2-1.8b")
    reqs = seeded_requests(model.cfg.vocab, 4, 6, 20, 5, 1, 0)
    kw = {"num_slots": 2, "max_seq": required_max_seq(reqs), "chunk": 4, "device": cuda,
          **({"block_size": 4} if paged else {"paged": False})}
    writer = ContinuousEngine(model, master, **kw)
    for r in reqs:
        writer.submit(r)
    steps = []
    while writer.step():
        writer.snapshot(tmp_path)
        steps.append(writer.step_count)

    def fingerprint(eng):
        return ([(c.request_id, c.new_tokens.tolist(), c.finish_reason, c.finish_step)
                 for c in eng.completions], eng.event_log, eng.step_count)

    want = fingerprint(writer)
    restorer = ContinuousEngine(model, master, **kw)
    restorer.run(reqs)
    captured = dict(restorer.shards[0]._graphs.captures)
    for step in steps:
        restorer.restore(tmp_path, step)
        while restorer.step():
            pass
        assert fingerprint(restorer) == want, step
    assert restorer.shards[0]._graphs.captures == captured  # resumed by replay alone


# ---------------------------------------------------------- sharded engine --
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_two_shards_on_the_card_equal_one_device_and_the_cpu(cuda, kv_dtype):
    """Two shards of cuda:0 (or of cuda:0 and cuda:1 where the machine has
    two cards), reduced internlm2-1.8b at f32: every tick a replay of its
    shard's graphs, one graph a shard a key, and the tokens of the one-device
    engine on the card and of the two-shard engine on the CPU."""
    cfg = reduce_config(get_config("internlm2-1.8b"), dtype="float32")
    model = make_model(cfg)
    master = model.init(0, "cpu")
    reqs = seeded_requests(cfg.vocab, 6, 4, 24, 6, seed=7)
    kw = dict(num_slots=4, max_seq=required_max_seq(reqs), chunk=4, block_size=8,
              kv_dtype=kv_dtype)
    device = None if torch.cuda.device_count() >= 2 else "cuda:0"
    toks = []
    for devices, dev in ((2, device), (1, "cuda"), (2, "cpu")):
        eng = ContinuousEngine(model, master, devices=devices, device=dev, **kw)
        toks.append({c.request_id: c.new_tokens.tolist() for c in eng.run(reqs)})
        m = eng.metrics()
        if dev != "cpu":
            assert m["transfer_guarded_ticks"] == m["model_ticks"]
            keys = len(m["fused_buckets"]) + len(m["decode_buckets"])
            assert m["graph_captures"] == [keys] * devices
    assert toks[0] == toks[1] == toks[2]
