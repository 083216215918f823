"""The port's sharded training over a (data, model) mesh on the CPU: the
logical-axis rules on DTensor (``parallel/sharding.py``), ``launch.train
--mesh`` over gloo ranks (``launch/_host_devices.py``) and
``store.restore_sharded``, against the reference.

  * every ``ParamSpec`` tree of the port equals the reference's
    ``model.param_specs()`` in shape and ``logical_axes``, all twelve
    reduced configs;
  * ``ShardingCtx.spec``, ``spec_for_shape`` and ``placements`` agree with
    the reference's ``ShardingCtx`` over a JAX ``AbstractMesh`` of the same
    shape, (2, 2), (4, 2) and (2, 16, 16), under the default and the SP
    rules (no host devices forced: the abstract mesh carries only a shape);
  * without a context every helper is the identity, and a malformed mesh
    and the rank checks raise;
  * one spawn of 4 gloo ranks, for reduced internlm2-1.8b and then
    mixtral-8x22b at f32: the sharded forward on (2, 2) within 1e-5 of one
    device's (measured <= 3e-7), ``launch.train --mesh 2x2`` for 4 steps whose
    losses fall and equal the unsharded launcher's within the 1e-5 relative
    that ``test_torch_train.py`` holds the port's step to JAX's (measured
    <= 1e-7), the step-4 checkpoint restored onto (4, 1) for step 5; the JAX
    ``store.restore`` reads that checkpoint, and the JAX step 5 from it gives
    the sharded step 5's loss within 1e-5 relative; in the same spawn, MLA
    and whisper, whose mixers run whole on local shards, take step-1
    gradients within 1e-5 relative L2 of one device's on (2, 2);
  * marked slow, the counterpart of ``tests/test_distributed.py``: 8 ranks,
    a (2, 4) mesh restored onto (4, 2), both archs.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import store as jax_store
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import list_archs
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models.layers import ParamSpec as JaxParamSpec
from repro.models.transformer import make_model as jax_make_model
from repro.parallel import sharding as jax_sharding
from repro.train import optimizer as jax_opt
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.launch import _host_devices
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import make_model
from repro_torch.parallel import sharding

import _torch_mesh_ranks as ranks

TOL = 1e-5  # relative: test_torch_train.py's port-to-JAX step tolerance


def _flat_specs(tree, prefix=""):
    if isinstance(tree, (ParamSpec, JaxParamSpec)):
        return {prefix: (tuple(tree.shape), tuple(tree.logical_axes))}
    out = {}
    for k, v in tree.items():
        out.update(_flat_specs(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_carry_the_references_logical_axes(arch):
    want = _flat_specs(jax_make_model(jax_reduce_config(jax_get_config(arch))).param_specs())
    got = _flat_specs(make_model(reduce_config(get_config(arch))).param_specs())
    assert got == want


# --------------------------------------------------------------- the rules --
class _Mesh(AbstractMesh):
    """The reference's abstract mesh with the ``devices`` array shape its
    ``sharding_for_shape`` reads."""

    @property
    def devices(self):
        return np.empty(tuple(self.axis_sizes), dtype=object)


MESHES = {"2x2": ((2, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ACTIVATIONS = [("batch", "seq", "embed_act"), ("batch", None, "embed_act"),
               ("batch", "seq", "vocab"), ("batch", "heads_act", None, None),
               ("batch", "kv_seq", "heads_act", None), ("group", None, None), ("group",),
               ("seq", "vocab"), (None, "batch"), ("batch", "batch"), ("kv_seq", "ff_act"),
               ("nope", "expert")]
ACT_SHAPES = [(8, 16, 64, 16), (1, 32768, 4096, 128), (3, 5, 7, 9), (64, 64, 64, 64)]


def _cases():
    """(shape, logical axes) pairs: every parameter of every arch, full size
    and reduced, and the activation sites' axes at several shapes."""
    seen = set()
    for arch in list_archs():
        for cfg in (get_config(arch), reduce_config(get_config(arch))):
            seen.update(_flat_specs(make_model(cfg).param_specs()).values())
    for axes in ACTIVATIONS:
        seen.update((shape[:len(axes)], axes) for shape in ACT_SHAPES)
    return sorted(seen, key=repr)


CASES = _cases()


def _placements_of(spec, names):
    """The DTensor placements a reference spec lays out (row-major over a
    dim's mesh axes)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in names]
    for d, m in enumerate(spec):
        for a in (() if m is None else m if isinstance(m, tuple) else (m,)):
            out[names.index(a)] = Shard(d)
    return out


@pytest.mark.parametrize("rules", ["default", "sp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharding_ctx_agrees_with_the_reference(mesh, rules):
    shape, names = MESHES[mesh]
    over = sharding.SP_OVERRIDES if rules == "sp" else {}
    assert sharding.SP_OVERRIDES == jax_sharding.SP_OVERRIDES
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    ref = jax_sharding.ShardingCtx(_Mesh(shape, names), {**jax_sharding.DEFAULT_RULES, **over})
    got = sharding.ShardingCtx(sharding.MeshShape(shape, names),
                               {**sharding.DEFAULT_RULES, **over})
    assert len(CASES) > 150
    for dims, axes in CASES:
        assert got.spec(axes) == tuple(ref.spec(axes)), axes
        want = tuple(ref.sharding_for_shape(dims, axes).spec)
        assert got.spec_for_shape(dims, axes) == want, (dims, axes)
        assert got.placements(dims, axes) == _placements_of(want, names), (dims, axes)


def test_helpers_are_the_identity_without_a_context_and_refusals_raise(monkeypatch):
    x = torch.randn(2, 3, 8)
    assert sharding.current_ctx() is None
    assert sharding.shard(x, "batch", "seq", "embed_act") is x
    assert sharding.local_kernel(lambda a: a, (x,), (("batch",),), ("batch",)) is x
    model = make_model(reduce_config(get_config("internlm2-1.8b")))
    params = model.init(0, "cpu")
    assert sharding.distribute_params(model, params) is params
    assert sharding.param_placements(model.param_specs()) is None
    with sharding.use_sharding(sharding.MeshShape((2, 2), ("data", "model"))) as ctx:
        assert sharding.current_ctx() is ctx and sharding.shard(x, "batch") is x  # plain
        assert ctx.rules["batch"] == ("pod", "data")
    assert sharding.current_ctx() is None
    swapped = sharding.ShardingCtx(sharding.MeshShape((2, 2), ("data", "pod")),
                                   dict(sharding.DEFAULT_RULES))
    with pytest.raises(ValueError, match="mesh's order"):
        swapped.placements((4, 8), ("batch", None))
    assert parse_mesh("2x4") == (2, 4)
    for bad in ("2", "2x", "0x2", "axb"):
        with pytest.raises(ValueError, match="--mesh"):
            parse_mesh(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL puts no two ranks"):
        _host_devices.check_ranks(2, "cuda")
    _host_devices.check_ranks(1, "cuda")
    _host_devices.check_ranks(8, "cpu")  # gloo ranks share the host
    with pytest.raises(ValueError):
        _host_devices.backend_of("meta")


# ------------------------------------------------------- sharded training --
def _log(path):
    return [json.loads(line) for line in path.open()]


def _jax_step5(arch, ckpt):
    """The JAX step 5 at f32 from the sharded run's step-4 checkpoint (read
    by the JAX store), on the port's batch 4: its loss."""
    cfg = jax_reduce_config(jax_get_config(arch), dtype="float32")
    model = jax_make_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    opt_cfg = jax_opt.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=5)
    like = (params, jax_opt.init_opt_state(opt_cfg, params))
    (params, opt_state), man = jax_store.restore(ckpt, 4, like)
    assert man["step"] == 4 and man["extra"] == {"arch": cfg.name}
    data = DataConfig(vocab=cfg.vocab, seq_len=ranks.SEQ, global_batch=ranks.BATCH, seed=1234)
    batch = {"tokens": jnp.asarray(batch_at(data, 4)["tokens"])}
    _, _, metrics = jax.jit(jax_make_train_step(model, opt_cfg))(params, opt_state, batch)
    return float(metrics["loss"])


def test_mesh_training_equals_one_device_and_restores_onto_another_mesh(tmp_path):
    """One spawn of 4 gloo ranks runs ``ranks.train_and_remesh``; then, in
    this process, the unsharded launcher and the JAX step 5."""
    got = _host_devices.run_ranks(4, ranks.train_and_remesh, (str(tmp_path / "mesh"),), "cpu")
    for arch in ranks.ARCHS:
        assert got[arch]["forward_gap"] <= 1e-5, arch
        mesh_log = _log(tmp_path / "mesh" / arch / "train_log.jsonl")
        assert [r["step"] for r in mesh_log] == [1, 2, 3, 4, 5]
        one = tmp_path / "one" / arch
        with ranks.f32_launcher():
            train_launch.main(ranks.launcher_args(arch, one, 4))
        want = [r["loss"] for r in _log(one / "train_log.jsonl")]
        losses = [r["loss"] for r in mesh_log]
        assert losses[3] < losses[0], losses
        for a, b in zip(losses, want):
            assert abs(a - b) <= TOL * abs(b), (arch, losses, want)
        assert got[arch]["final_2x2"] == losses[3] and got[arch]["final_4x1"] == losses[4]
        step5 = _jax_step5(arch, tmp_path / "mesh" / arch / "ckpt")
        assert abs(losses[4] - step5) <= TOL * abs(step5), (arch, losses[4], step5)
    for arch in ranks.MIXER_ARCHS:  # measured <= 5.4e-7
        assert got[arch]["grad_gap"] <= TOL, (arch, got[arch])


@pytest.mark.slow  # 8 gloo ranks per arch: multi-rank train + elastic restore
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b"])
def test_sharded_training_and_elastic_restore(arch, tmp_path):
    """The counterpart of ``tests/test_distributed.py``: the sharded forward
    within the reference's 0.05, sharded steps lowering the loss, a (2, 4)
    checkpoint restored onto (4, 2) with the new mesh's placements, and a
    finite step after it."""
    out = _host_devices.run_ranks(8, ranks.elastic_check, (arch, str(tmp_path)), "cpu")
    assert out["forward_gap"] <= 0.05
    assert out["losses"][-1] < out["losses"][0], out["losses"]
    assert out["step"] == 4 and np.isfinite(out["step5"])
    assert out["placed"][0] == out["placed"][1] == "(Shard(dim=1), Shard(dim=2))"
