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
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_paged_attention import ops as attn_ops
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.kv_cache import BlockPagedKVPool

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
