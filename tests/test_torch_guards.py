"""Guards of the port's package boundary and device rules: no JAX and no
``repro`` import anywhere in it, entry points that raise instead of
running on the CPU uninvited, CPU wrappers that never count a launch, and
a package that imports without ``nvcc`` or ``triton``."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.core.luts import SoftmaxLUTConfig
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.kv_cache import BlockPagedKVPool

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "kernel_ab.py"]


def _imported_roots(nodes) -> set[str]:
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), str(path))
    anywhere = _imported_roots(ast.walk(tree)) & {"jax", "jaxlib", "repro"}
    assert not anywhere, f"{path} imports {anywhere}"
    # triton may only be imported inside the function that launches a kernel
    assert "triton" not in _imported_roots(tree.body), f"{path} imports triton at top level"


def test_package_imports_without_nvcc_or_triton():
    """Every module imports in a fresh process that has no triton and no
    nvcc on PATH, and importing builds nothing."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._libs and 'triton' not in sys.modules and 'jax' not in sys.modules\n"
    )
    env = {"PATH": "/nonexistent", "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_walk_finds_every_module():
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.kernels.gn_paged_attention.ops", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.kernels.gn_softmax.ops",
            "repro_torch.kernels.gn_attention.ops", "repro_torch.data.synthetic"} <= names


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu_and_a_device(monkeypatch):
    _no_cuda(monkeypatch)
    model = make_model(reduce_config(get_config("internlm2-1.8b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(seed=0)
    params = model.init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(model, params, num_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockPagedKVPool(model, num_slots=1, max_seq=8, block_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--smoke", "--continuous"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--smoke"])  # the static mode
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(batch=1, max_seq=8)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_cpu_wrappers_leave_launch_counters_at_zero():
    ops = (norm_ops, attn_ops, sm_ops, fa_ops)
    before = tuple(m.launches for m in ops)
    x = torch.randn(3, 32)
    norm_ops.gn_rmsnorm(x, torch.ones(32))
    norm_ops.gn_layernorm(x, torch.ones(32), torch.zeros(32))
    norm_ops.gn_add_rmsnorm(x, x, torch.ones(32))
    norm_ops.gn_add_layernorm(x, x, torch.ones(32), torch.zeros(32))
    assert norm_ops.launches_fused == 0
    q = torch.randn(2, 1, 2, 8)
    kv = torch.randn(3, 4, 1, 8)
    attn_ops.gn_paged_attention_chunk(q, kv, kv, torch.zeros(2, 1, dtype=torch.int32),
                                      torch.tensor([0, 2], dtype=torch.int32),
                                      torch.tensor([1, 1], dtype=torch.int32))
    sm_ops.gn_softmax(x)
    sm_ops.gn_softmax(x.bfloat16())
    fa_ops.gn_attention(torch.randn(1, 4, 5, 8), torch.randn(1, 2, 7, 8),
                        torch.randn(1, 2, 7, 8), causal=True)
    assert tuple(m.launches for m in ops) == before == (0, 0, 0, 0)


def test_wrappers_refuse_other_devices():
    x = torch.randn(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        norm_ops.gn_rmsnorm(x)
    meta = torch.zeros(1, 1, 1, 8, device="meta")
    ints = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        attn_ops.gn_paged_attention_chunk(meta, meta, meta, ints, ints[0], ints[0])
    with pytest.raises(ValueError, match="cpu or cuda"):
        sm_ops.gn_softmax(x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.gn_attention(meta, meta, meta, causal=True)


def test_fused_norm_refuses_inputs_that_do_not_match():
    """The fused add + norm takes x and r of one shape, dtype (f32 or bf16)
    and device, both contiguous, and raises otherwise on any device."""
    x = torch.randn(4, 16)
    g = torch.ones(16)
    bad = [(x, torch.randn(4, 8)), (x, torch.randn(2, 4, 16)), (x, x.bfloat16()),
           (x, torch.randn(4, 16, device="meta")), (x, torch.randn(16, 4).t()),
           (torch.randn(16, 4).t(), x)]
    for a, b in bad:
        with pytest.raises(ValueError, match="alike and contiguous"):
            norm_ops.gn_add_rmsnorm(a, b, g)
        with pytest.raises(ValueError, match="alike and contiguous"):
            norm_ops.gn_add_layernorm(a, b, g, torch.zeros(16))
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="takes"):
            norm_ops.gn_add_rmsnorm(x.to(dt), x.to(dt), g)
    meta = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        norm_ops.gn_add_rmsnorm(meta, meta)
    assert norm_ops.launches == norm_ops.launches_fused == 0


def test_flash_attention_check_refuses_lut_values_the_bf16_split_cannot_hold():
    """The bf16 tensor-core design takes LUT values of at most 17 bits (the
    exact hi + lo split of each numerator); a finer LUT in bf16 is routed to
    the CUDA-core design by ``design``, not refused, and f32 always takes
    the CUDA-core design.  The wrapper's check accepts every case."""
    q, kv = torch.zeros(1, 2, 4, 8), torch.zeros(1, 1, 4, 8)
    for bits in (15, 16, 17):
        cfg = SoftmaxLUTConfig(3, lut_value_bits=bits)
        assert fa_ops.design(torch.bfloat16, cfg) == "tensor_core"
        assert fa_ops.design(torch.float32, cfg) == "cuda_core"
    coarse = SoftmaxLUTConfig(3, lut_value_bits=18)
    assert fa_ops.design(torch.bfloat16, coarse) == "cuda_core"
    assert fa_ops.design(torch.float32, coarse) == "cuda_core"
    fa_ops._check(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    fa_ops._check(q, kv, kv)


@pytest.mark.parametrize("bits", [15, 16, 17, 18])
@pytest.mark.parametrize("d", [16, 64, 128, 20])
def test_paged_read_design_route(d, bits):
    """The paged read's route (fp and int8 arenas alike): the tensor-core
    design for bf16 q when the numerators split exactly (at most 17 LUT bits),
    D is a multiple of 16 up to 256, at most 64 rows share a block and the
    pointers sit on 16 bytes; the CUDA-core design for everything else."""
    cfg = SoftmaxLUTConfig(3, lut_value_bits=bits)
    tc = bits <= 17 and d % 16 == 0
    for rows in (1, 2, 16, 32, 64):
        assert attn_ops.design(torch.bfloat16, cfg, d, rows) == (
            "tensor_core" if tc else "cuda_core")
        assert attn_ops.design(torch.float32, cfg, d, rows) == "cuda_core"
    assert attn_ops.design(torch.bfloat16, cfg, d, 65) == "cuda_core"
    assert attn_ops.design(torch.bfloat16, cfg, d, 32, aligned=False) == "cuda_core"
