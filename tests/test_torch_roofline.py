"""The port's roofline (``repro_torch.roofline``), each kernel's ``work()``
and ``launch/profile_cell`` on the CPU.

* ``work()`` reproduces PERF.md §6's bounds within 1% (NVIDIA H100 SXM
  peaks): the norm at (128, 2048) bf16 RMS, 0.000315 ms (bytes); the
  softmax's fused entry at the static prefill's (8, 8, 2, 1024, 1024) bf16
  scores under the causal mask, 0.1606 ms (bytes); the flash attention at
  B 8, H 16, Hkv 8, S 1056, D 128 causal bf16, 0.0370 ms (operations); the
  paged read's bytes and operations equal the hand count its bound was
  worked out by (every live K/V block once, q and the output once, the
  tables and ints; q.k and p.v over the visible pairs).
* ``op_cost``'s FLOPs for a chain of matmuls equal the reference's
  ``hlo_cost.module_cost`` flops exactly on the same numpy input.  For the
  reduced internlm2-1.8b forward at f32 they are 0.908 of ``module_cost``
  of the JAX forward on the same converted weights (measured; the port
  counts the GN kernels by ``work()`` and elementwise ops one a result,
  XLA its fusions' own ops): held to [0.85, 1.0].
* ``profile_cell`` on the CPU prints its counts and "not measured" for
  every time, on each path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import pair
from repro.roofline.hlo_cost import module_cost as jax_module_cost
from repro_torch.analysis.op_walk import record
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_paged_attention import ops as paged_ops
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.launch import profile_cell
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_cost import kernel_work, module_cost

META = "meta"  # shapes and dtypes only: no memory behind the §6 shapes


def _bound(work):
    return roofline.work_bound(work)


def test_norm_work_reproduces_row_2():
    x = torch.empty(128, 2048, dtype=torch.bfloat16, device=META)
    gamma = torch.empty(2048, device=META)
    b = _bound(norm_ops.work(x, None, gamma, None, subtract_mean=False))
    assert b.by == "bytes" and b.ms == pytest.approx(0.000315, rel=0.01)
    fused = _bound(norm_ops.work(x, x, gamma, None, subtract_mean=False))
    assert fused.ms == pytest.approx(2 * 0.000315, rel=0.01)  # row 2b: 0.000628


def test_fused_softmax_work_reproduces_row_3():
    scores = torch.empty(8, 8, 2, 1024, 1024, dtype=torch.bfloat16, device=META)
    mask = torch.empty(1, 1, 1, 1024, 1024, dtype=torch.bool, device=META)
    b = _bound(sm_ops.scores_work(scores, 128 ** -0.5, mask, torch.bfloat16))
    assert b.by == "bytes" and b.ms == pytest.approx(0.1606, rel=0.01)
    # the mask as the model passes it, a broadcast view: its own elements count
    view = torch.ones(1024, 1024, dtype=torch.bool).tril()[None, None, None].expand(
        8, 8, 2, 1024, 1024)
    assert sm_ops.scores_work(scores, None, view).bytes == sm_ops.scores_work(
        scores, None, mask).bytes


def test_flash_work_reproduces_row_4():
    q = torch.empty(8, 16, 1056, 128, dtype=torch.bfloat16, device=META)
    k = torch.empty(8, 8, 1056, 128, dtype=torch.bfloat16, device=META)
    b = _bound(fa_ops.work(q, k, k, causal=True))
    assert b.by == "operations" and b.ms == pytest.approx(0.0370, rel=0.01)
    # the visible pairs: causal, non-causal, and a sliding window's band
    assert fa_ops.visible_pairs(1056, 1056, True) == 1056 * 1057 // 2
    assert fa_ops.visible_pairs(5, 7, False) == 35
    band = sum(min(4, i + 7 - 5 + 1) for i in range(5))
    assert fa_ops.visible_pairs(5, 7, True, window=4) == band


@pytest.mark.parametrize("int8", [False, True])
def test_paged_work_counts_live_blocks_and_visible_pairs(int8):
    n, c, h, hkv, d, bs, max_bt = 4, 3, 8, 2, 16, 4, 6
    rng = np.random.default_rng(int8)
    lengths = np.array([0, 5, 17, 24])
    n_valid = np.minimum(np.array([0, 3, 2, 3]), lengths)
    starts = lengths - n_valid
    dtype = torch.int8 if int8 else torch.bfloat16
    q = torch.zeros(n, c, h, d, dtype=torch.bfloat16)
    arena = torch.zeros(20, bs, hkv, d, dtype=dtype)
    tables = torch.as_tensor(rng.integers(0, 20, size=(n, max_bt)), dtype=torch.int32)
    scales = (torch.zeros(20), torch.zeros(20)) if int8 else None
    w = paged_ops.work(q, arena, arena, tables, torch.as_tensor(starts, dtype=torch.int32),
                       torch.as_tensor(n_valid, dtype=torch.int32), scales=scales)
    blocks = sum(-(-int(L) // bs) for L in lengths)
    want_bytes = (2 * blocks * bs * hkv * d * arena.element_size() + (8 * blocks if int8 else 0)
                  + 2 * q.numel() * 2 + 4 * (tables.numel() + 2 * n))
    seen = sum(min(int(L) - int(nv) + i + 1, int(L)) for L, nv in zip(lengths, n_valid)
               for i in range(int(nv)))
    assert (w.flops, w.bytes, w.precision) == (4 * h * d * seen, want_bytes, "bf16")


def test_bound_names_the_larger_term_and_refuses_unknown_cards(monkeypatch):
    assert roofline.bound(989e12, 1.0, torch.bfloat16) == (1000.0, "operations")
    assert roofline.bound(1.0, 3.35e12, "f32") == (1000.0, "bytes")
    with pytest.raises(KeyError):
        roofline.bound(1.0, 1.0, torch.float64)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=0: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no published peaks"):
        roofline.card()


# ------------------------------------------------------------- op_cost ---
def test_matmul_chain_flops_equal_the_references():
    x = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)

    def chain_jax(a):
        for _ in range(4):
            a = a @ a
        return a

    hlo = jax.jit(chain_jax).lower(jnp.asarray(x)).compile().as_text()

    def chain_torch():
        a = torch.from_numpy(x)
        for _ in range(4):
            a = a @ a
        return a

    _, records = record(chain_torch)
    assert module_cost(records).total_flops == jax_module_cost(hlo).flops == 4 * 2 * 256 ** 3


def test_reduced_forward_flops_within_band_of_the_references():
    jmodel, jparams, model, master = pair("internlm2-1.8b")
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab, size=(2, 32)).astype(np.int32)
    hlo = jax.jit(jmodel.forward).lower(jparams, {"tokens": jnp.asarray(tokens)}).compile()
    ref = jax_module_cost(hlo.as_text()).flops
    params = model.prepare(master, "cpu")
    _, records = record(lambda: model.forward(params, {"tokens": torch.from_numpy(tokens)}),
                        keep_alive=False)
    mine = module_cost(records)
    assert 0.85 <= mine.total_flops / ref <= 1.0, (mine.total_flops, ref)
    # every layer's kernels carry their work: 2 norms a layer + the final one,
    # the flash attention a layer
    work = kernel_work(records)
    layers = model.cfg.n_layers
    assert work["gn_attention"].calls == layers
    assert work["gn_rmsnorm"].calls + work["gn_rmsnorm_fused"].calls == 2 * layers + 1


# -------------------------------------------------------- profile_cell ---
@pytest.mark.parametrize("path", ["continuous", "static", "train"])
def test_profile_cell_counts_on_cpu(path, capsys):
    out = profile_cell.main(["--smoke", "--device", "cpu", "--path", path, "--top", "3"])
    text = capsys.readouterr().out
    assert out["step_bound_ms"] > 0 and out["device_ms"] is None and out["wall_ms"] is None
    assert "not measured" in text and "top 3 by bytes" in text
    assert out["gn"] and all(g["device_ms"] is None for g in out["gn"].values())
