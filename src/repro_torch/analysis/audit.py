"""Pass A: the op-trace invariant auditor (the port's counterpart of
``repro/analysis/audit.py``).

The reference re-traces every jitted serving entry point to a jaxpr and
checks its structure.  The port's ticks are eager Python captured into
CUDA graphs, so the auditor records one eager call of each entry point
with ``op_walk.OpRecorder`` (every aten op with its tensors' dtypes,
shapes, devices and storages; each hand-written kernel one opaque record)
and checks the record.  Per arch it builds a smoke engine (``build_engine``,
the reference's reduced shapes) or takes one the caller passes (the
full-width engines on the card), runs a small staggered workload so the
engine sees its (step kind, horizon bucket) keys, then records the tick
body ``_Shard._tick`` of every shard at each seen key with every lane
parked (the graphs' own warm-up call: every op runs, nothing observable is
written) and asserts:

* **A-GATHER**: arena gathers (``GATHER_OPS`` with an arena's storage as
  the source) whose output covers the whole bucketed stream (num_slots x
  bucket blocks, the reference's ``stream_gather_hits``) stay within the
  read path's ``GATHER_BUDGETS`` a layer (the reference counts one scanned
  layer body; the port's layers are a Python loop), at every bucket wider
  than the streamed
  read's K tile (``attention.STREAM_TILE`` columns; at or below it a tile
  is the stream).
* **A-DONATE -> in place**: every pool and cache leaf keeps its storage
  across the call, and no op outputs a tensor of a whole arena's or slab's
  shape (all layers, one layer, or rows flattened) outside the arenas: a
  copy of the cache, the port's form of a dropped donation.  The SSM
  carries are rewritten from their own values every lane by design; only
  their storage is held.
* **A-F64**: no op input or output is float64 or complex.
* **A-TRANSFER**: no ``SYNC_OPS`` op and no copy across devices inside the
  body.  The boundary is named, not recorded: ``ContinuousEngine.step``
  stages the tick's inputs with ``copy_`` before the body and takes one
  device->host copy a shard after it; on the card the DtoH copies of a
  profiled window of replayed ticks must be ``dtoh_budget``: one a shard a
  tick.
* **A-TRACEKEY**: ``check_trace_keys`` over ``metrics()``: the seen keys
  lie in ``tracekeys.trace_key_space``; with graphs the capture counts
  equal the seen keys per kind within ``compile_bound``, and on the CPU,
  where nothing is captured, they are 0.
* **A-QUANT**: with int8 arenas no floating tensor has a whole arena's
  shape (``paged_quant_write`` and the reads dequantize per gathered tile).
* **A-SENTINEL**: with sentinels on, the model step's health outputs
  (``paged_probe_word`` a layer, the head's sigma probe) are reachable in
  the record's storage dataflow from the arenas and from the tick's inputs.

``tier="full"`` adds, for a paged pool, the tick under each other forced
read path (``attention.FORCE_PAGED_READ``; engines built and not run: the
parked tick needs only the bucket's table buffer) and the int8 pool.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.analysis import tracekeys
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.op_walk import OpRecord, OpRecorder, TensorInfo, reaches
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.models import attention
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.workload import required_max_seq, staggered_requests

# ops that read rows of their first tensor through an index tensor
GATHER_OPS = frozenset({"aten.index", "aten._unsafe_index", "aten.index_select",
                        "aten.gather", "aten.embedding"})
# ops that wait for the device: a scalar read, or an output sized by the data
SYNC_OPS = frozenset({"aten._local_scalar_dense", "aten.item", "aten.nonzero",
                      "aten.masked_select", "aten.unique", "aten._unique2"})
COPY_OPS = frozenset({"aten._to_copy", "aten.copy_", "aten.copy"})
# float dtypes a tick may hold: the model dtype and f32, never wider
ALLOWED_FLOAT_DTYPES = frozenset({torch.bfloat16, torch.float16, torch.float32})

# (read path, MLA) -> (stream gathers a tick may make, why)
GATHER_BUDGETS = {
    ("kernel", False): (0, "the kernel is the read: one opaque record, no gather outside it"),
    ("streamed", False): (1, "the V read over the horizon; K is gathered STREAM_TILE table "
                             "columns at a time (models/attention.py _paged_read_plain)"),
    ("gathered", False): (2, "the oracle's full K and V streams"),
    ("streamed", True): (2, "each latent arena (c_kv, k_rope) gathered once over the "
                            "horizon and expanded once (models/mla.py _gather_latent), measured "
                            "faster on an H100 than 32-column tiles; the reference streams "
                            "both tiles (its budget 0)"),
    ("gathered", True): (2, "the MLA oracle's latent and rope streams"),
}


@dataclasses.dataclass
class EntryPoint:
    """One eager call of a serving entry point and what its checks need."""

    name: str
    call: Callable[[], object]
    leaves: Callable[[], dict]            # the pool's leaves, read before and after
    kv_leaves: tuple[str, ...] = ()       # leaves whose whole shape must not be copied
    gather: Optional[tuple[int, int, int]] = None  # (budget a layer, layers, stream blocks)
    quantized: bool = False               # A-QUANT: no fp tensor at an arena shape
    health: Optional[Callable] = None     # A-SENTINEL: call's output -> health tensors
    sources: Callable[[], list] = lambda: []  # the tick's inputs (A-SENTINEL)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr() if t.numel() else 0


def _arena_shapes(leaf: torch.Tensor) -> set[tuple]:
    """A leaf's whole shape, one layer's, and one layer's rows flattened."""
    shape = tuple(leaf.shape)
    out = {shape}
    if len(shape) >= 3:
        out |= {shape[1:], (shape[1] * shape[2],) + shape[3:]}
    return out


def _block_elems(leaf: torch.Tensor) -> int:
    """Elements of one block (paged arena) or one slot (slab) of a layer."""
    return math.prod(leaf.shape[2:])


def _wide(dtype: torch.dtype) -> bool:
    return (dtype.is_floating_point or dtype.is_complex) and dtype not in ALLOWED_FLOAT_DTYPES


def _transfer(r: OpRecord) -> bool:
    """An op in SYNC_OPS, a copy across devices, or an op whose tensors
    span devices (a 0-dim CPU operand is a scalar argument, not a copy)."""
    if r.name in SYNC_OPS:
        return True
    devs = {t.device for t in r.outputs}
    devs |= {t.device for t in r.inputs
             if r.name in COPY_OPS or not (t.device == "cpu" and t.shape == ())}
    return len(devs - {"meta"}) > 1


def _fmt(t: TensorInfo) -> str:
    return f"{str(t.dtype).split('.')[-1]}{list(t.shape)}"


def stream_gather_hits(records: list[OpRecord], arenas: dict, blocks: int) -> list[str]:
    """Recorded gathers whose source is one of ``arenas`` and whose output
    covers at least ``blocks`` of its blocks: the whole bucketed stream."""
    per_block = {_storage(v): _block_elems(v) for v in arenas.values()}
    return [f"{r.name} {_fmt(r.inputs[0])} -> {_fmt(r.outputs[0])}" for r in records
            if r.name in GATHER_OPS and not r.opaque and r.inputs and r.outputs
            and r.inputs[0].storage in per_block
            and r.outputs[0].elems >= blocks * per_block[r.inputs[0].storage]]


def check_records(ep: EntryPoint, records: list[OpRecord], before: dict, after: dict,
                  out, where: str) -> list[Finding]:
    """Every rule that reads a recorded call, on ``ep``'s record."""
    findings: list[Finding] = []
    kv = {k: after[k] for k in ep.kv_leaves if k in after}
    arena_storages = {_storage(v) for v in before.values()} | {_storage(v) for v in after.values()}
    arena_shapes = set().union(*(_arena_shapes(v) for v in kv.values())) if kv else set()

    # A-DONATE
    moved = sorted(k for k in before if k not in after or _storage(after[k]) != _storage(before[k]))
    if moved:
        findings.append(Finding("A-DONATE", "error", where,
                                f"leaves {moved} changed storage across the call: a captured "
                                "graph keeps reading the old buffers"))
    copies = [f"{r.name} -> {_fmt(t)}" for r in records for t in r.outputs
              if t.shape in arena_shapes and t.storage not in arena_storages
              and t.storage not in {i.storage for i in r.inputs}]  # a view is no copy
    if copies:
        findings.append(Finding("A-DONATE", "error", where,
                                f"{len(copies)} op output(s) of a whole arena's or slab's shape "
                                f"outside the arenas (a copy of the cache): {copies[:6]}"))
    # A-QUANT
    if ep.quantized:
        fp = [f"{r.name} -> {_fmt(t)}" for r in records for t in r.outputs
              if t.shape in arena_shapes and t.dtype.is_floating_point]
        if fp:
            findings.append(Finding("A-QUANT", "error", where,
                                    f"{len(fp)} floating tensor(s) of a whole int8 arena's shape "
                                    f"(the fp stream materialized): {fp[:6]}"))
    # A-GATHER
    if ep.gather is not None:
        budget, layers, blocks = ep.gather
        hits = stream_gather_hits(records, kv, blocks)
        if len(hits) > budget * layers:
            findings.append(Finding("A-GATHER", "error", where,
                                    f"{len(hits)} stream-materializing arena gathers over "
                                    f"{layers} layers, budget {budget} a layer ({blocks} blocks "
                                    f"a stream): {hits[:6]}"))
    # A-F64
    wide = sorted({str(t.dtype) for r in records for t in r.inputs + r.outputs if _wide(t.dtype)})
    if wide:
        findings.append(Finding("A-F64", "error", where,
                                f"wide float dtypes inside the call: {wide} (allowed: "
                                f"{sorted(str(d) for d in ALLOWED_FLOAT_DTYPES)})"))
    # A-TRANSFER
    syncs = [f"{r.name}({', '.join(t.device for t in r.inputs)} -> "
             f"{', '.join(t.device for t in r.outputs)})" for r in records if _transfer(r)]
    if syncs:
        findings.append(Finding("A-TRANSFER", "error", where,
                                f"{len(syncs)} host sync(s) or transfer(s) inside the body: "
                                f"{syncs[:6]}"))
    # A-SENTINEL
    if ep.health is not None:
        sources = {"the arenas": {_storage(after[k]) for k in kv},
                   "the tick's inputs": {_storage(t) for t in ep.sources()}}
        for i, h in enumerate(ep.health(out)):
            cut = [label for label, src in sources.items()
                   if not reaches(records, {_storage(h)}, src)]
            if cut:
                findings.append(Finding("A-SENTINEL", "error", where,
                                        f"health output {i} {str(h.dtype).split('.')[-1]}"
                                        f"{list(h.shape)} has no data path from {cut}: the probe "
                                        "is disconnected"))
    return findings


def record_entry_point(ep: EntryPoint, opaque_kernels: bool = True):
    """(output, records, leaves before, leaves after) of one eager call."""
    before = dict(ep.leaves())
    with torch.no_grad(), OpRecorder(opaque_kernels=opaque_kernels) as rec:
        out = ep.call()
    return out, rec.records, before, dict(ep.leaves())


def audit_entry_point(ep: EntryPoint, where: str) -> list[Finding]:
    out, records, before, after = record_entry_point(ep)
    return check_records(ep, records, before, after, out, where)


# ------------------------------------------------------------ trace keys --
def check_trace_keys(metrics: dict, where: str, *, paged: bool, captures: bool,
                     max_seq: int = 0, block_size: int = 0, engine_grid=None) -> list[Finding]:
    """The A-TRACEKEY core (fixture-drivable): the grid derived from the
    configuration against the engine's and the metrics', the seen keys
    inside the space, and the capture counts: per kind the number of seen
    keys (paged) or one per step kind run (slab), within the bound; 0
    without graphs (``captures`` False: the CPU)."""
    findings: list[Finding] = []
    if paged:
        derived = tracekeys.horizon_bucket_grid(max_seq, block_size)
        for label, grid in (("engine", engine_grid),
                            ("metrics", metrics.get("horizon_bucket_grid"))):
            if grid is not None and list(grid) != derived:
                findings.append(Finding("A-TRACEKEY", "error", where,
                                        f"{label} grid {list(grid)} != derived grid {derived} "
                                        f"(max_seq={max_seq}, block_size={block_size})"))
                return findings
        space = tracekeys.trace_key_space(paged=True, grid=derived)
        bound = tracekeys.compile_bound(paged=True, grid=derived)
        seen = tracekeys.seen_trace_keys(metrics)
        exact = {k: sum(1 for kind, _ in seen if kind == k) for k in tracekeys.STEP_KINDS}
    else:
        space = tracekeys.trace_key_space(paged=False)
        bound = tracekeys.compile_bound(paged=False)
        seen = tracekeys.seen_trace_keys(metrics)
        fused = metrics.get("fused_ticks", 0)
        exact = {"fused": int(fused > 0), "decode": int(metrics.get("model_ticks", 0) > fused)}
    counts = {"fused": metrics["fused_step_compilations"],
              "decode": metrics["decode_compilations"]}
    if not captures:
        exact = dict.fromkeys(tracekeys.STEP_KINDS, 0)
    diff = tracekeys.format_trace_key_diff(space, seen, counts)
    if not seen <= space:
        findings.append(Finding("A-TRACEKEY", "error", where,
                                "captured keys outside the enumerated space\n" + diff))
    for kind in tracekeys.STEP_KINDS:
        if counts[kind] != exact[kind] or counts[kind] > bound[kind]:
            findings.append(Finding("A-TRACEKEY", "error", where,
                                    f"{kind} captures {counts[kind]} != {exact[kind]} "
                                    f"(bound {bound[kind]})\n" + diff))
    if metrics.get("prefill_compilations", 0) != 0:
        findings.append(Finding("A-TRACEKEY", "error", where,
                                f"prefill_compilations={metrics['prefill_compilations']}: "
                                "per-prompt-length capture reintroduced"))
    return findings


def audit_trace_keys(engine, where: str) -> list[Finding]:
    return check_trace_keys(
        engine.metrics(), where, paged=engine.paged,
        captures=engine.shards[0]._graphs is not None,
        max_seq=engine.max_seq, block_size=engine.pool.block_size if engine.paged else 0,
        engine_grid=engine.horizon_bucket_grid if engine.paged else None)


# --------------------------------------------------------- entry points --
def build_engine(arch: str, *, num_slots: int = 2, chunk: int = 4, block_size: int = 4,
                 kv_dtype: str = "fp", device=None, devices: int = 1, **over):
    """A smoke-scale engine for one registry arch, and its workload: the
    reference's shapes, with prompts up to 36 tokens so that the paged
    tick's widest bucket (10 blocks of 4) exceeds the streamed read's K
    tile; ``devices`` shards it (``device`` then names the one device all
    shards take, None for one card each)."""
    cfg = reduce_config(get_config(arch), **over)
    model = make_model(cfg)
    reqs = staggered_requests(cfg, n_requests=4, base_len=24, max_new_tokens=4, stagger=1)
    kw = dict(num_slots=num_slots, max_seq=required_max_seq(reqs), cfg=ServeConfig(),
              chunk=min(chunk, cfg.sliding_window or chunk), device=device, devices=devices)
    if model.supports_paging:
        kw.update(block_size=block_size, kv_dtype=kv_dtype)
    return ContinuousEngine(model, model.init(0, device), **kw), reqs


def read_budget(engine) -> tuple[int, str]:
    return GATHER_BUDGETS[(engine.read_path, engine.model.cfg.mla is not None)]


def kv_leaf_names(engine) -> tuple[str, ...]:
    """The pool leaves a copy of which would be a copy of the cache: the
    arenas or slabs, without the int8 scales, the SSM carries (rewritten
    from their own values every lane) and the per-request extras."""
    model = engine.model
    skip = set(model.carry_leaves) | set(model.extra_leaves)
    return tuple(k for k in engine.pool.caches[0]
                 if not k.endswith("_scale") and k not in skip)


def dtoh_budget(engine, ticks: int) -> int:
    """Device->host copies ``ticks`` replayed ticks may make: one a shard
    a tick (its tokens and health words in one copy)."""
    return ticks * engine.num_devices


def _seen_kinds(engine) -> list[tuple[str, Optional[int]]]:
    """(kind, bucket) keys the engine ran since its reset (slab: bucket None)."""
    if engine.paged:
        return sorted((kind, b) for kind, bs in engine._buckets_seen.items() for b in bs)
    kinds = [("fused", None)] if engine.fused_ticks else []
    return kinds + ([("decode", None)] if engine.model_ticks > engine.fused_ticks else [])


def _on_read_path(engine, fn: Callable) -> Callable:
    """``fn`` run under the paged read the engine was built for (the
    model step reads ``attention.FORCE_PAGED_READ`` at call time; the
    engine's ``step`` refuses a change, a direct call would not)."""
    if not engine.paged:
        return fn

    def call():
        prev = attention.FORCE_PAGED_READ
        attention.FORCE_PAGED_READ = engine.read_path
        try:
            return fn()
        finally:
            attention.FORCE_PAGED_READ = prev
    return call


def collect_entry_points(engine, keys=None) -> list[EntryPoint]:
    """Every shard's tick at each seen key (or ``keys``), every lane parked;
    its model step with the sentinels' health at the widest fused bucket;
    and the pool's in-place copies (a prefix fork, or a slab insert).  A
    sharded engine's entry points end in ``@<shard>``."""
    eps = []
    for sh in engine.shards:
        tag = "" if engine.num_devices == 1 else f"@{sh.index}"
        eps += [dataclasses.replace(ep, name=ep.name + tag)
                for ep in _shard_entry_points(engine, sh, keys)]
    return eps


def _shard_entry_points(engine, sh, keys) -> list[EntryPoint]:
    leaves = lambda: sh.cache  # noqa: E731 (read anew: a rebind shows)
    kv = kv_leaf_names(engine)
    quantized = getattr(engine.pool, "kv_dtype", "fp") == "int8"
    budget = read_budget(engine)[0] if engine.paged else None
    keys = _seen_kinds(engine) if keys is None else keys
    eps = []
    for kind, bucket in keys:
        tables = None if bucket is None else sh._tables_dev[bucket]
        gather = ((budget, engine.model.cfg.n_layers, sh.n * bucket)
                  if budget is not None and bucket > attention.STREAM_TILE else None)
        eps.append(EntryPoint(
            name=f"{kind}_tick" + ("" if bucket is None else f"[{bucket}]"),
            call=_on_read_path(engine, lambda kind=kind, tables=tables: sh._tick(
                sh._parked, kind, *sh._inputs[kind], tables)),
            leaves=leaves, kv_leaves=kv, gather=gather, quantized=quantized))
    fused = [b for kind, b in keys if kind == "fused" and b is not None]
    if engine.paged and engine.sentinels and fused:
        tokens, _, _ = sh._inputs["fused"]
        parked = torch.zeros_like(sh._pos_dev)
        tables = sh._tables_dev[max(fused)]
        eps.append(EntryPoint(
            name=f"sentinel_step[{max(fused)}]",
            call=_on_read_path(engine, lambda: engine.model.fused_step_slots_paged(
                sh.params, sh.cache, tokens, sh._pos_dev, parked, tables,
                sentinel=True, extras=sh.extras)),
            leaves=leaves, kv_leaves=kv, quantized=quantized,
            health=lambda out: [out[1]["layers"], out[1]["head"]],
            sources=lambda: [tokens, sh._pos_dev, parked, tables]))
    if engine.paged:
        first = sh.index * engine.pool.blocks_per_device  # the shard's block 0, global
        eps.append(EntryPoint(name="prefix_cow_fork",
                              call=lambda: engine.pool.fork_block(first, first),
                              leaves=leaves, kv_leaves=kv, quantized=quantized))
    else:
        eps.append(EntryPoint(
            name="slot_insert",
            call=lambda: engine.model.insert_cache_slot(sh.cache, engine._fresh, 0),
            leaves=leaves, kv_leaves=kv))
    return eps


def audit_engine(engine, label: str) -> list[Finding]:
    """Every audit rule over a drained engine that has served a workload:
    its trace keys, then each entry point's record."""
    findings = audit_trace_keys(engine, f"{label}:trace_keys")
    eps = collect_entry_points(engine)
    for ep in eps:
        findings.extend(audit_entry_point(ep, f"{label}:{ep.name}"))
    if engine.paged and not any(ep.gather for ep in eps):
        findings.append(Finding("A-GATHER", "error", f"{label}:workload",
                                f"no bucket wider than {attention.STREAM_TILE} blocks was seen: "
                                "the workload cannot tell a tile from a stream"))
    return findings


def audit_arch(arch: str, *, tier: str = "full", device=None, **over) -> list[Finding]:
    """Pass A for one arch at its smoke size; ``tier="full"`` adds the other
    forced read paths and, paged, the int8 pool (``devices=N`` in ``over``
    shards each engine)."""
    engine, reqs = build_engine(arch, device=device, **over)
    engine.run(reqs)
    findings = audit_engine(engine, arch)
    if tier != "full" or not engine.paged:
        return findings
    widest = [("fused", max(engine.horizon_bucket_grid))]
    paths = ["gathered"] if engine.model.cfg.mla is not None else ["streamed", "gathered"]
    prev = attention.FORCE_PAGED_READ
    try:
        for path in [p for p in paths if p != engine.read_path]:
            attention.FORCE_PAGED_READ = path
            v_engine, _ = build_engine(arch, device=device, **over)
            for ep in collect_entry_points(v_engine, widest):
                findings.extend(audit_entry_point(ep, f"{arch}[{path}]:{ep.name}"))
    finally:
        attention.FORCE_PAGED_READ = prev
    q_engine, q_reqs = build_engine(arch, kv_dtype="int8", device=device, **over)
    q_engine.run(q_reqs)
    findings.extend(audit_engine(q_engine, f"{arch}:int8"))
    return findings


def run_audit(archs: Optional[list[str]] = None, *, tier: str = "full", device=None,
              log=lambda msg: None) -> tuple[list[Finding], list[str]]:
    archs = list(archs) if archs else list_archs()
    findings: list[Finding] = []
    for arch in archs:
        log(f"audit: {arch}")
        findings.extend(audit_arch(arch, tier=tier, device=device))
    return findings, archs


# -------------------------------------------------- replays on the card --
def memcpy_records(prof) -> dict[str, int]:
    """Memcpy records by direction ("DtoH", "HtoD", "DtoD") in a profiler
    trace of CUDA activity."""
    out: dict[str, int] = {}
    for e in prof.key_averages():
        if "Memcpy" in e.key:
            for kind in ("DtoH", "HtoD", "DtoD", "PtoP"):
                if kind in e.key:
                    out[kind] = out.get(kind, 0) + e.count
    return out
