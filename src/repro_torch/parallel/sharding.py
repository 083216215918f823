"""Logical-axis sharding rules for FSDP + TP + EP + SP on a DTensor
``DeviceMesh`` (port of ``repro/parallel/sharding.py``), and the device
placement of the sharded serving pool.

Parameters and activations carry *logical* axis names (``ParamSpec.
logical_axes``, the ``shard(x, ...)`` sites); a rules table maps them to
mesh dims.  A launcher installs a :class:`ShardingCtx` with
``use_sharding(mesh)``; without one every helper is a no-op and every
tensor stays a plain ``torch.Tensor``, so the models run unchanged on one
device.  Under a context the parameters are DTensors
(``distribute_params``), ``shard`` redistributes an activation to the
placements its axes give, and ``local_kernel`` runs a kernel wrapper over
the local shards of its DTensor arguments (``local_map``): a kernel's
ctypes launch is invisible to the dispatcher, so a DTensor never reaches
one.

Default mapping (the reference's, verbatim):
  * ``embed_fsdp``  -> 'data'            (FSDP: params sharded over data)
  * ``heads_tp``/``ff``/``vocab``/``expert`` -> 'model'   (tensor/expert parallel)
  * ``batch``       -> ('pod', 'data')   (pure DP across pods)
  * ``kv_seq``      -> 'model', and under ``SP_OVERRIDES`` ('pod', 'data', 'model')

A tuple of mesh axes on one tensor dim shards that dim over each of them in
row-major order, as ``NamedSharding`` lays it out: DTensor splits a dim
sharded over several mesh dims in mesh-dim order, so the tuple must list
them in that order (every rule does).

The serving half: ``make_slot_mesh`` returns the devices of a slot-sharded
continuous engine, one a shard (the reference's 1-D ``("data",)`` mesh over
the slot axis, weights replicated).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

DEFAULT_RULES: dict[str, object] = {
    "embed_fsdp": "data",
    "heads_tp": "model",
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",
    "group": ("pod", "data"),   # MoE dispatch groups follow the batch axis
    "embed_act": None,          # residual-stream feature dim
    "heads_act": "model",       # activation heads dim (TP)
    "ff_act": "model",
}

# Sequence-parallel override for batch=1 long-context decode.
SP_OVERRIDES = {
    "batch": None,
    "kv_seq": ("pod", "data", "model"),
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes without devices or a process group (the
    reference's ``AbstractMesh``): enough for ``ShardingCtx.spec`` and
    ``placements``, for tests and ahead-of-time planning."""
    shape: tuple
    mesh_dim_names: tuple


@dataclasses.dataclass
class ShardingCtx:
    mesh: object  # a torch DeviceMesh, or a MeshShape
    rules: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names)

    def spec(self, logical_axes: tuple) -> tuple:
        """Per tensor dim, the mesh axis (or tuple of them, or None) it shards
        over: the reference's ``PartitionSpec``.  A mesh axis shards at most
        one dim, the first logical axis naming it wins, and mesh axes the
        mesh lacks are dropped."""
        parts = []
        used: set[str] = set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            if isinstance(m, tuple):
                m = tuple(a for a in m if a in self.axis_names and a not in used)
                m = m if m else None
                if isinstance(m, tuple) and len(m) == 1:
                    m = m[0]
            elif m is not None and (m not in self.axis_names or m in used):
                m = None
            if m is not None:
                used.update(m if isinstance(m, tuple) else (m,))
            parts.append(m)
        return tuple(parts)

    def spec_for_shape(self, shape: tuple, logical_axes: tuple) -> tuple:
        """``spec`` with every mesh axis that does not divide its dim dropped
        (the value replicates along it): the reference's
        ``sharding_for_shape``."""
        sizes = dict(zip(self.axis_names, self.mesh.shape))
        base = self.spec(logical_axes)
        parts = []
        used: set[str] = set()
        for dim, m in zip(shape, base + (None,) * (len(shape) - len(base))):
            if m is None:
                parts.append(None)
                continue
            total, kept = 1, []
            for a in (m if isinstance(m, tuple) else (m,)):
                if a not in used and dim % (total * sizes[a]) == 0:
                    kept.append(a)
                    used.add(a)
                    total *= sizes[a]
            parts.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
        return tuple(parts)

    def placements(self, shape: tuple, logical_axes: tuple) -> list:
        """The DTensor placements (one a mesh dim: ``Shard(d)`` or
        ``Replicate()``) of a tensor of ``shape`` under ``logical_axes``."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self.axis_names]
        for d, m in enumerate(self.spec_for_shape(shape, logical_axes)):
            axes = () if m is None else (m if isinstance(m, tuple) else (m,))
            dims = [self.axis_names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(f"dim {d} shards over {axes}, not in the mesh's order "
                                 f"{self.axis_names}: DTensor cannot lay that out")
            for i in dims:
                out[i] = Shard(d)
        return out


_tls = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, overrides: dict | None = None):
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    prev = current_ctx()
    _tls.ctx = ShardingCtx(mesh, rules)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


def is_dtensor(x) -> bool:
    if not torch.is_tensor(x):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, *logical_axes):
    """Annotate an activation with logical axes: without a context, or on a
    plain tensor, ``x`` itself; on a DTensor its redistribution to the
    placements the rules give."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    want = tuple(ctx.placements(tuple(x.shape), tuple(logical_axes)))
    return x if tuple(x.placements) == want else x.redistribute(placements=want)


def local_kernel(fn, args: tuple, in_axes: tuple, out_axes, like: int = 0):
    """``fn(*args)``, over the local shards of ``args`` when a context is
    installed and one of them is a DTensor (``local_map``).

    ``in_axes[i]`` names the logical axes of ``args[i]`` (None for a plain
    tensor or None argument, which goes in as it is); each DTensor argument
    is redistributed to the placements of its axes.  ``out_axes`` names the
    axes of the output (a tuple of names), or of each output (a tuple of
    such tuples); each is placed by the shape of ``args[like]``, so a dim
    dropped from the input's placements (a mesh axis that does not divide
    it) is dropped from the output's too.  Without a context, or with no
    DTensor argument, this is ``fn(*args)`` and nothing else."""
    ctx = current_ctx()
    if ctx is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(ctx.placements(tuple(a.shape), ax) if is_dtensor(a) else None
                  for a, ax in zip(args, in_axes))
    ref_shape = tuple(args[like].shape)
    multi = isinstance(out_axes[0], tuple)
    # local_map reads a tuple as one placement list per output, a list as one output's
    out_pl = (tuple(ctx.placements(ref_shape, ax) for ax in out_axes) if multi
              else ctx.placements(ref_shape, out_axes))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl), device_mesh=ctx.mesh,
                     redistribute_inputs=True)(*args)


def local_mixer(fn, rows: tuple, p: dict):
    """``fn(*rows, p)``, a whole mixer, over local shards when a context is
    installed and ``rows[0]`` is a DTensor: each tensor of ``rows`` (x, and
    a cross-attention's memory) split by its leading dim on the ``batch``
    axes, the rest whole (a plain tensor, which every rank holds whole, is
    split alike), every weight of the tree ``p`` gathered whole on each
    rank.  For
    the mixers whose ops DTensor cannot propagate on every torch the port
    runs on (the SSM and hybrid mixers' grouped convs and scans, MLA's and
    cross-attention's score einsums): the ``model`` axis then splits none of
    their work, and their weights' gradients sum over the ranks whose rows
    differ.  Without a context this is ``fn(*rows, p)``."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(rows[0]):
        return fn(*rows, p)
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(p)
    placed = [ctx.placements(tuple(t.shape), ("batch",)) for t in rows]
    rows = [t if is_dtensor(t) else distribute_tensor(t, ctx.mesh, pl, src_data_rank=None)
            for t, pl in zip(rows, placed)]
    whole = [Replicate() for _ in ctx.axis_names]
    in_pl = (*placed, *(whole if is_dtensor(leaf) else None for leaf in leaves))

    def body(*args):
        return fn(*args[:len(rows)], tree_unflatten(list(args[len(rows):]), spec))

    return local_map(body, out_placements=placed[0], in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl), device_mesh=ctx.mesh,
                     redistribute_inputs=True)(*rows, *leaves)


def grad_placements(in_pl: tuple) -> tuple:
    """The placements of the local gradients of a ``local_map`` call's
    inputs placed ``in_pl`` (None for a non-DTensor input): an input
    replicated along a mesh dim that splits another input (a norm's gamma
    beside batch-sharded rows, a router beside experts split over
    ``model``) takes a different local gradient on each rank along it, a
    ``Partial`` sum; elsewhere the gradient is placed as the input."""
    from torch.distributed.tensor import Partial, Replicate

    split = {i for pl in in_pl if pl is not None
             for i, one in enumerate(pl) if one != Replicate()}
    return tuple(None if pl is None else
                 [Partial() if i in split and one == Replicate() else one
                  for i, one in enumerate(pl)] for pl in in_pl)


def param_placements(spec_tree):
    """ParamSpec tree -> tree of DTensor placements under the installed
    context (None without one): the reference's ``param_sharding_tree``."""
    from repro_torch.models.layers import ParamSpec

    ctx = current_ctx()
    if ctx is None:
        return None

    def walk(s):
        if isinstance(s, ParamSpec):
            return ctx.placements(tuple(s.shape), tuple(s.logical_axes))
        return {k: walk(v) for k, v in s.items()}

    return walk(spec_tree)


def distribute_params(model, params: dict) -> dict:
    """Every leaf of ``params`` (the full f32 masters, the same on every
    rank) as a DTensor on the installed context's mesh, placed by its
    ``ParamSpec.logical_axes``; each rank keeps its own chunk, with no
    communication.  Without a context, ``params`` itself."""
    placements = param_placements(model.param_specs())
    if placements is None:
        return params
    return place_tree(params, placements, current_ctx().mesh)


def place_tree(tree, placements, mesh):
    """Each tensor leaf of ``tree`` as a DTensor of the matching placements
    leaf on ``mesh`` (a leaf whose placements are None stays as it is)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: place_tree(v, placements[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_tree(v, p, mesh) for v, p in zip(tree, placements))
    if placements is None:
        return tree
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, placements)
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


def make_slot_mesh(num_devices: int, device=None) -> list[torch.device]:
    """The devices of an ``num_devices``-way slot-sharded engine, shard d on
    the d-th: ``cuda:0 .. cuda:N-1`` (raising when fewer are visible) when
    ``device`` is None, else ``device`` for every shard (N shards of one
    device: the CPU tests' ``"cpu"``, or one card)."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if device is not None:
        return [torch.device(device)] * num_devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_devices > visible:
        raise ValueError(
            f"slot mesh wants {num_devices} devices but only {visible} are visible; pass "
            f"device='cuda:0' (or 'cpu') to put all {num_devices} shards on one device")
    return [torch.device("cuda", d) for d in range(num_devices)]
