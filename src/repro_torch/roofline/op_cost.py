"""The work of a recorded op trace (the port's counterpart of
``repro/roofline/hlo_cost.py``).

``analysis.op_walk`` records one eager call of a step, op by op; this
module costs the record:

* matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and the ``einsum``s and
  ``@``s that lower to them) by ``torch.utils.flop_counter``'s formulas
  (2·M·N·K), at the precision of their inputs;
* elementwise ops at one operation per output element and reductions at
  one per input element (XLA's ``HloCostAnalysis`` convention), at the f32
  rate of the CUDA cores;
* bytes as each op's inputs plus its outputs (a broadcast input counted at
  its own elements), views and allocations at none, gathers and scatters
  at what they touch (twice the rows moved, plus the indices);
* each hand-written kernel (an opaque record) through its wrapper's
  ``work()``;
* the c10d functional collectives that DTensor issues under a mesh
  (``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single``, their coalesced and
  in-place forms, and a broadcast) by the reference's ring accounting
  (``hlo_cost.py``): an all-reduce moves twice its operand, an all-gather
  its output, any other its operand, per device.

The bytes are an **unfused** count: every eager op's operands cross HBM.
XLA's fusion-boundary bytes, which the reference's ``hlo_cost`` reports,
are another quantity (a fusion's internal temporaries never reach HBM), so
the two agree on matmul FLOPs and not on bytes.  A CUDA graph replays the
same launches, so the unfused count is what the replayed tick moves.

The reference needs trip-count machinery because XLA costs a ``while``
body once; the port's layers are a Python loop that dispatches every
layer's ops, so the record already holds each op as many times as it runs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.op_walk import OpRecord
from repro_torch.roofline.analysis import HBM_BYTES_PER_S, PEAK_FLOPS, PRECISION, Bound

ELEMENTWISE = frozenset(f"aten.{n}" for n in (
    "add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_", "neg", "abs", "pow", "exp",
    "exp_", "log", "log1p", "expm1", "sqrt", "rsqrt", "reciprocal", "sin", "cos", "tanh",
    "sigmoid", "silu", "gelu", "erf", "relu", "clamp", "clamp_", "clamp_min", "clamp_max",
    "maximum", "minimum", "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "round", "floor", "ceil", "trunc", "sign", "remainder", "fmod", "floor_divide",
    "isfinite", "isinf", "isnan", "_to_copy", "lerp", "addcmul", "addcdiv", "masked_fill",
    "masked_fill_", "fill_", "zero_", "softplus", "square", "nan_to_num", "atan2"))
REDUCTIONS = frozenset(f"aten.{n}" for n in (
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "cumsum",
    "logsumexp", "var", "std", "norm", "linalg_vector_norm", "any", "all", "_softmax",
    "_log_softmax", "topk", "sort"))
# no bytes moved, no operations: views, metadata, allocations
FREE = frozenset(f"aten.{n}" for n in (
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute", "transpose", "t",
    "unsqueeze", "squeeze", "select", "slice", "as_strided", "alias", "detach", "lift_fresh",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "unfold", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided", "view_as_real",
    "view_as_complex", "_local_scalar_dense"))
# c10d functional collective -> the reference's kind (``hlo_cost._COLLECTIVE_KINDS``)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute", "collective-broadcast")
COLLECTIVES = {f"{ns}.{op}": kind for ns in ("_c10d_functional", "c10d_functional")
               for op, kind in (
                   ("all_reduce", "all-reduce"), ("all_reduce_", "all-reduce"),
                   ("all_reduce_coalesced", "all-reduce"), ("all_reduce_coalesced_", "all-reduce"),
                   ("all_gather_into_tensor", "all-gather"),
                   ("all_gather_into_tensor_out", "all-gather"),
                   ("all_gather_into_tensor_coalesced", "all-gather"),
                   ("reduce_scatter_tensor", "reduce-scatter"),
                   ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                   ("all_to_all_single", "all-to-all"),
                   ("permute_tensor", "collective-permute"),
                   ("broadcast", "collective-broadcast"), ("broadcast_", "collective-broadcast"))}
# waits and autograd wrappers of a collective's result: no traffic of their own
COLLECTIVE_FREE = frozenset(f"{ns}.{op}" for ns in ("_c10d_functional", "c10d_functional")
                            for op in ("wait_tensor", "_wrap_tensor_autograd"))
GATHERS = frozenset(f"aten.{n}" for n in (
    "index", "_unsafe_index", "index_select", "gather", "embedding"))
SCATTERS = frozenset(f"aten.{n}" for n in (
    "index_copy_", "index_copy", "index_put_", "index_put", "scatter", "scatter_",
    "scatter_add_", "scatter_reduce_", "scatter_reduce", "index_add_", "copy_"))


@dataclasses.dataclass
class OpCost:
    """One op's (or a group of ops') work: operations per precision, bytes,
    and the bytes each device moves over the interconnect by collective
    kind (``COLLECTIVE_KINDS``)."""

    flops: dict = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    calls: int = 0
    collective: dict = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def collective_total(self) -> float:
        return sum(self.collective.values())

    def add(self, other: "OpCost") -> None:
        for p, f in other.flops.items():
            self.flops[p] = self.flops.get(p, 0.0) + f
        for k, b in other.collective.items():
            self.collective[k] = self.collective.get(k, 0.0) + b
        self.bytes += other.bytes
        self.calls += other.calls

    def bound(self) -> Bound:
        """The larger of the bytes term and the operations term (each
        precision's operations over its own peak, summed)."""
        t_ops = sum(f / PEAK_FLOPS[p] for p, f in self.flops.items()) * 1e3
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        return Bound(t_bytes, "bytes") if t_bytes >= t_ops else Bound(t_ops, "operations")


def op_cost(r: OpRecord) -> OpCost:
    """The work of one recorded op or kernel call."""
    if r.opaque:
        w = r.work
        return OpCost({w.precision: float(w.flops)} if w.flops else {}, float(w.bytes), 1)
    if r.name in FREE or r.name in COLLECTIVE_FREE:
        return OpCost(calls=1)
    ins = sum(t.nbytes for t in r.inputs)
    outs = sum(t.nbytes for t in r.outputs)
    if r.name in COLLECTIVES:  # ring accounting; the operand read and the result written
        kind = COLLECTIVES[r.name]
        moved = {"all-reduce": 2.0 * ins, "all-gather": float(outs)}.get(kind, float(ins))
        return OpCost(bytes=float(ins + outs), calls=1, collective={kind: moved})
    if r.name in GATHERS:  # the rows moved, read and written, and the indices
        idx = sum(t.nbytes for t in r.inputs[1:])
        return OpCost(bytes=2.0 * outs + idx, calls=1)
    if r.name in SCATTERS:  # the source rows read and written, and the indices
        src = r.inputs[-1].nbytes if r.inputs else 0
        idx = sum(t.nbytes for t in r.inputs[1:-1])
        return OpCost(bytes=2.0 * src + idx, calls=1)
    flops: dict = {}
    if r.matmul_flops:
        prec = PRECISION.get(r.inputs[0].dtype, "f32") if r.inputs else "f32"
        flops[prec] = r.matmul_flops
    elif r.name in ELEMENTWISE:
        flops["f32"] = float(sum(t.elems for t in r.outputs))
    elif r.name in REDUCTIONS:
        flops["f32"] = float(r.inputs[0].elems) if r.inputs else 0.0
    return OpCost(flops, float(ins + outs), 1)


def label(r: OpRecord) -> str:
    """A breakdown key: the op or kernel and its first output."""
    out = r.outputs[0] if r.outputs else None
    shape = f" {str(out.dtype).split('.')[-1]}{list(out.shape)}" if out else ""
    return f"{r.name}{shape}"


def module_cost(records: list[OpRecord]) -> OpCost:
    """The whole record's work."""
    total = OpCost()
    for r in records:
        total.add(op_cost(r))
    return total


def cost_breakdown(records: list[OpRecord], top_k: int = 25) -> dict:
    """Work by op and shape (``label``), summed over the record: the top
    ``top_k`` by bytes and by operations, each (label, OpCost)."""
    groups: dict[str, OpCost] = {}
    for r in records:
        groups.setdefault(label(r), OpCost()).add(op_cost(r))
    items = list(groups.items())
    return {"by_bytes": sorted(items, key=lambda kv: -kv[1].bytes)[:top_k],
            "by_flops": sorted(items, key=lambda kv: -kv[1].total_flops)[:top_k]}


def kernel_work(records: list[OpRecord]) -> dict[str, OpCost]:
    """Each hand-written kernel's summed ``work()`` over the record."""
    out: dict[str, OpCost] = {}
    for r in records:
        if r.opaque:
            out.setdefault(r.name, OpCost()).add(op_cost(r))
    return out



def collective_bytes(records: list[OpRecord]) -> dict:
    """Per-device collective bytes by kind, and their ``total`` (the
    reference's ``hlo_cost.collective_bytes``)."""
    c = module_cost(records)
    out = {k: c.collective.get(k, 0.0) for k in COLLECTIVE_KINDS}
    out["total"] = c.collective_total
    return out
