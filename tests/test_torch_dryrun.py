"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) and what it
needs, held to the reference (``repro.launch.dryrun``'s inputs) on the CPU.

  * ``param_count`` and ``active_param_count`` of all twelve registered
    configs, ``ASSIGNED_ARCHS``, the production shapes and
    ``shapes_for_arch`` equal the reference's exactly;
  * for every assigned arch at full width and each of its shapes,
    ``input_specs`` and ``input_logical_axes`` (with the decode cache's
    ``cache_specs`` and ``cache_logical_axes``) equal the reference's leaf
    for leaf: shapes, dtypes and axes (shapes only: nothing is allocated);
  * on both production meshes (over a fake process group of 256 or 512
    ranks in this process) each parameter's local shard has the shape of
    the reference's ``ShardingCtx.sharding_for_shape`` on a stand-in mesh
    (``NamedSharding`` patched to hand back the spec), and the dry run's
    parameter bytes are their sum;
  * the collective accounting is the reference's ring accounting: an
    all-reduce of f32[1024] over 4 fake ranks moves 2 * 1024 * 4 bytes (the
    reference's ``test_psum_bytes_counted``), an all-gather its output, a
    reduce-scatter its operand;
  * each GN kernel wrapper takes a shape-only route on meta tensors (its
    plain version's output shapes and dtypes, one opaque record with its
    ``work()``) while a real CPU tensor still goes through the plain version;
  * ``run_cell`` over reduced configs at the production shapes (dense
    train, prefill and decode, MoE train, zamba2's long_500k under
    ``SP_OVERRIDES``) on the production meshes: every cell ok, the
    reference's JSON keys, argument bytes equal to the reference's shard
    shapes' sum, and the train cells' gradients reduced across ranks.
"""
import json
import types

import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import input_logical_axes as jax_input_logical_axes
from repro.configs.registry import input_specs as jax_input_specs
from repro.configs.registry import list_archs
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models.layers import ParamSpec as JaxParamSpec
from repro.models.transformer import make_model as jax_make_model
from repro.parallel import sharding as jax_sharding
from repro.roofline import analysis as jax_analysis
from repro.roofline import hlo_cost as jax_hlo_cost
from repro_torch.analysis.op_walk import record
from repro_torch.configs import base
from repro_torch.configs.registry import (ASSIGNED_ARCHS, get_config, input_logical_axes,
                                          input_specs, reduce_config)
from repro_torch.kernels.gn_attention import ops as fa_ops
from repro_torch.kernels.gn_attention import ref as fa_ref
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_layernorm import ref as norm_ref
from repro_torch.kernels.gn_paged_attention import ops as paged_ops
from repro_torch.kernels.gn_paged_attention import ref as paged_ref
from repro_torch.kernels.gn_softmax import ops as sm_ops
from repro_torch.kernels.gn_softmax import ref as sm_ref
from repro_torch.launch import dryrun
from repro_torch.launch.fake_group import fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import make_model
from repro_torch.parallel import sharding
from repro_torch.roofline import op_cost
from repro_torch.serve.engine import _leaf_path

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _leaves(tree, prefix="", is_leaf=lambda x: False):
    """path -> leaf of a nested dict (int keys as their digits)."""
    if not isinstance(tree, dict) or is_leaf(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k), is_leaf))
    return out


# ------------------------------------------------------------ counts, shapes --
@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_the_references(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()


def test_shapes_and_assigned_archs_equal_the_references():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS
    assert base.LONG_CONTEXT_ARCHS == jax_base.LONG_CONTEXT_ARCHS
    fields = lambda s: (s.name, s.seq_len, s.global_batch, s.kind)  # noqa: E731
    assert [fields(s) for s in base.ALL_SHAPES] == [fields(s) for s in jax_base.ALL_SHAPES]
    for arch in ASSIGNED_ARCHS + ("bert-base", "gpt-neo-1.3b"):
        assert ([fields(s) for s in base.shapes_for_arch(arch)]
                == [fields(s) for s in jax_base.shapes_for_arch(arch)])


# ------------------------------------------------------------------ specs --
def _ref_specs(arch, shape):
    """path -> (shape, dtype name, axes) of the reference's inputs."""
    cfg = jax_get_config(arch)
    sds = _leaves(jax_input_specs(cfg, shape), is_leaf=lambda x: not isinstance(x, dict))
    axes = _leaves(jax_input_logical_axes(cfg, shape), is_leaf=lambda x: isinstance(x, tuple))
    return {k: (tuple(v.shape), np.dtype(v.dtype).name, tuple(axes[k])) for k, v in sds.items()}


def _port_specs(arch, shape):
    """The same of the port's, its flat cache leaves at the reference's paths."""
    cfg = get_config(arch)
    specs, axes = input_specs(cfg, shape), input_logical_axes(cfg, shape)
    out = {}
    for name, spec in specs.items():
        if name == "cache":
            for leaf, (s, dt) in spec.items():
                out[f"cache/{_leaf_path(leaf)}"] = (tuple(s), str(dt).split(".")[-1],
                                                   tuple(axes["cache"][leaf]))
        else:
            out[name] = (tuple(spec[0]), str(spec[1]).split(".")[-1], tuple(axes[name]))
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_and_cache_specs_equal_the_references(arch):
    for shape, ref_shape in zip(base.shapes_for_arch(arch), jax_base.shapes_for_arch(arch)):
        want = _ref_specs(arch, ref_shape)
        got = _port_specs(arch, shape)
        assert got == want, (arch, shape.name)
        if shape.kind == "decode":
            model = make_model(get_config(arch))
            assert set(model.cache_logical_axes()) == set(
                model.cache_specs(shape.global_batch, shape.seq_len))


# -------------------------------------------------------------- the shards --
def _ref_shard(ctx, shape, axes, sizes) -> tuple:
    """The reference's shard shape of ``shape`` under ``axes``."""
    spec = ctx.sharding_for_shape(shape, axes)
    out = list(shape)
    for d, m in enumerate(tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))):
        for a in (() if m is None else m if isinstance(m, tuple) else (m,)):
            out[d] //= sizes[a]
    return tuple(out)


def _ref_ctx(monkeypatch, multi_pod: bool, overrides=None):
    """The reference's ``ShardingCtx`` on a stand-in for a production mesh."""
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: spec)
    shape, names = MESHES[multi_pod]
    mesh = types.SimpleNamespace(axis_names=names, devices=types.SimpleNamespace(shape=shape))
    rules = {**jax_sharding.DEFAULT_RULES, **(overrides or {})}
    return jax_sharding.ShardingCtx(mesh, rules), dict(zip(names, shape))


def _ref_param_shards(ctx, sizes, jax_cfg) -> dict:
    specs = _leaves(jax_make_model(jax_cfg).param_specs(),
                    is_leaf=lambda x: isinstance(x, JaxParamSpec))
    return {k: _ref_shard(ctx, tuple(s.shape), tuple(s.logical_axes), sizes)
            for k, s in specs.items()}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_parameter_shards_equal_the_references(arch, multi_pod, monkeypatch):
    ctx, sizes = _ref_ctx(monkeypatch, multi_pod)
    want = _ref_param_shards(ctx, sizes, jax_get_config(arch))
    model = make_model(get_config(arch))
    specs = _leaves(model.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with sharding.use_sharding(mesh) as port:
            got = {k: sharding.local_shape(tuple(s.shape),
                                           port.placements(tuple(s.shape), tuple(s.logical_axes)),
                                           mesh)
                   for k, s in specs.items()}
            with dryrun.recording_mode(types.SimpleNamespace(), dryrun.Meter()):
                nbytes = dryrun.local_bytes(dryrun.fake_params(model, "cpu"))
    assert got == want
    assert nbytes == 4 * sum(int(np.prod(s)) for s in want.values())


# ------------------------------------------------------------- collectives --
def test_collective_bytes_follow_the_reference_ring_accounting():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.op_walk import OpRecorder

    rec, meter = OpRecorder(keep_alive=False), dryrun.Meter()
    with fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with dryrun.recording_mode(rec, meter):
            x = torch.empty(1024, dtype=torch.float32)
            meter.on = True
            funcol.all_reduce(x, "sum", mesh)
    got = op_cost.collective_bytes(rec.records)
    # the reference's test_psum_bytes_counted: psum of f32[1024] over 4 devices
    assert got["all-reduce"] == 2 * 1024 * 4 and got["total"] == 2 * 1024 * 4
    assert set(got) == set(jax_hlo_cost._COLLECTIVE_KINDS) | {"total"}

    rec, meter = OpRecorder(keep_alive=False), dryrun.Meter()
    with fake_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with dryrun.recording_mode(rec, meter):
            x = torch.empty(256, 8, dtype=torch.bfloat16)
            meter.on = True
            funcol.all_gather_tensor(x, 0, mesh)  # output (1024, 8) bf16
            funcol.reduce_scatter_tensor(x, "sum", 0, mesh)  # operand (256, 8) bf16
    got = op_cost.collective_bytes(rec.records)
    assert got["all-gather"] == 1024 * 8 * 2
    assert got["reduce-scatter"] == 256 * 8 * 2
    assert got["total"] == got["all-gather"] + got["reduce-scatter"]
    costs = [op_cost.op_cost(r) for r in rec.records]
    assert sum(c.collective_total for c in costs) == got["total"]


# ------------------------------------------------------ the shape-only route --
def _wrapper_cases(dev, gen=None):
    """(name, call, plain) per kernel wrapper on tensors of ``dev``."""
    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, dtype=torch.float32).to(dtype).to(dev)

    q, k, v = t(2, 4, 8, 16), t(2, 2, 8, 16), t(2, 2, 8, 16)
    x, r, g = t(3, 5, 32, dtype=torch.bfloat16), t(3, 5, 32, dtype=torch.bfloat16), t(32)
    s = t(2, 3, 7, dtype=torch.bfloat16)
    mask = (torch.arange(7)[None, None, :] <= torch.arange(3)[None, :, None] + 4).to(dev)
    qq, arena = t(2, 3, 4, 16), t(5, 4, 2, 16)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32).to(dev)
    starts = torch.tensor([2, 0], dtype=torch.int32).to(dev)
    n_valid = torch.tensor([3, 1], dtype=torch.int32).to(dev)
    return {
        "gn_attention": (lambda: fa_ops.gn_attention(q, k, v, causal=True),
                         lambda: fa_ref.gn_attention_ref(q, k, v, causal=True,
                                                         sm_scale=16 ** -0.5)),
        "gn_rmsnorm": (lambda: norm_ops.gn_rmsnorm(x, g),
                       lambda: norm_ref.gn_layernorm_ref(x, g, None, subtract_mean=False)),
        "gn_rmsnorm_fused": (lambda: norm_ops.gn_add_rmsnorm(x, r, g),
                             lambda: norm_ref.gn_add_layernorm_ref(x, r, g, None,
                                                                   subtract_mean=False)),
        "gn_softmax": (lambda: sm_ops.gn_softmax(s), lambda: sm_ref.gn_softmax_ref(s)),
        "gn_softmax_scores": (lambda: sm_ops.gn_softmax_scores(s, 0.5, mask, torch.float32),
                              lambda: sm_ref.gn_softmax_scores_ref(s, 0.5, mask,
                                                                   torch.float32)),
        "gn_paged_attention": (
            lambda: paged_ops.gn_paged_attention_chunk(qq, arena, arena, tables, starts, n_valid,
                                                       nonfinite=True),
            lambda: paged_ref.gn_paged_attention_chunk_ref(qq, arena, arena, tables, starts,
                                                           n_valid, nonfinite=True)),
    }


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", ["gn_attention", "gn_rmsnorm", "gn_rmsnorm_fused",
                                  "gn_softmax", "gn_softmax_scores", "gn_paged_attention"])
def test_wrappers_take_a_shape_only_route_on_meta_tensors_only(name):
    cpu_call, plain = _wrapper_cases("cpu", torch.Generator().manual_seed(0))[name]
    meta_call, _ = _wrapper_cases("meta")[name]
    real, rec_real = record(cpu_call)
    shaped, rec_meta = record(meta_call)
    assert [(o.shape, o.dtype) for o in _flat(shaped)] == [(o.shape, o.dtype)
                                                           for o in _flat(real)]
    assert all(o.is_meta for o in _flat(shaped))
    (m,), (c,) = rec_meta, rec_real  # one opaque record each, the body's ops dropped
    assert m.opaque and c.opaque and m.name == c.name == name
    if name == "gn_paged_attention":  # unreadable lengths: every table column counted
        assert m.work.flops >= c.work.flops and m.work.bytes >= c.work.bytes
    else:
        assert m.work == c.work
    for got, want in zip(_flat(real), _flat(plain())):  # the CPU still runs the plain version
        assert torch.equal(got, want)


# --------------------------------------------------------- small dry runs --
SMALL_CELLS = [("internlm2-1.8b", "train_4k", False), ("internlm2-1.8b", "prefill_32k", False),
               ("internlm2-1.8b", "decode_32k", True), ("llama4-scout-17b-a16e", "train_4k", False),
               ("zamba2-7b", "long_500k", False)]


def _want_argument_bytes(monkeypatch, arch, shape, multi_pod) -> int:
    """The reference's shard shapes' bytes: the f32 parameters, the AdamW
    moments and step of a train cell, and the inputs (a train cell's whole
    token batch; a prefill's or decode's split by their logical axes)."""
    overrides = jax_sharding.SP_OVERRIDES if shape.name == "long_500k" else None
    ctx, sizes = _ref_ctx(monkeypatch, multi_pod, overrides)
    jax_cfg = jax_reduce_config(jax_get_config(arch))
    params = sum(int(np.prod(s)) for s in _ref_param_shards(ctx, sizes, jax_cfg).values())
    total = 4 * params
    if shape.kind == "train":
        state = np.dtype(jax_cfg.opt_state_dtype).itemsize
        total += 2 * state * params + 4
    sds = _leaves(jax_input_specs(jax_cfg, shape), is_leaf=lambda x: not isinstance(x, dict))
    axes = _leaves(jax_input_logical_axes(jax_cfg, shape), is_leaf=lambda x: isinstance(x, tuple))
    for k, s in sds.items():
        dims = tuple(s.shape)
        if shape.kind != "train" and dims:
            dims = _ref_shard(ctx, dims, tuple(axes[k]), sizes)
        total += int(np.prod(dims)) * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", SMALL_CELLS)
def test_small_dry_run_cells(arch, shape_name, multi_pod, tmp_path, monkeypatch):
    shape = {s.name: s for s in base.ALL_SHAPES}[shape_name]
    rec = dryrun.run_cell(arch, shape, multi_pod, tmp_path, "cpu",
                          reduce_config(get_config(arch)))
    assert rec["ok"], rec.get("traceback")
    saved = json.loads((tmp_path / f"{arch}__{shape_name}__{rec['mesh']}.json").read_text())
    assert saved["ok"] and saved["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    # the reference's keys (its compile_s, generated code and XLA cost have no counterpart)
    assert {"arch", "shape", "mesh", "ok", "lower_s", "memory", "collective_bytes",
            "roofline"} <= set(saved)
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= set(saved["memory"])
    assert set(saved["collective_bytes"]) == set(jax_hlo_cost._COLLECTIVE_KINDS) | {"total"}
    ref_roof = jax_analysis.Roofline(1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    assert set(saved["roofline"]) == set(ref_roof.to_dict())
    assert saved["roofline"]["n_chips"] == (512 if multi_pod else 256)
    want = _want_argument_bytes(monkeypatch, arch, shape, multi_pod)
    assert saved["memory"]["argument_bytes"] == want
    assert saved["memory"]["temp_bytes"] > 0
    if shape.kind == "train":  # the gradients reduced across the data ranks
        coll = saved["collective_bytes"]
        assert coll["all-reduce"] + coll["reduce-scatter"] > 0
