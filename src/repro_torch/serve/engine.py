"""Serving engines (port of ``repro/serve/engine.py``): the static path
(``generate``, ``perplexity``, ``static_reference``) and the
continuous-batching engine with chunked prefill fused into the tick
(``ContinuousEngine``: FCFS or priority admission, block-paged fp or int8
KV or a slab a slot, one device or sharded over several, GN runtime
sentinels on by default over the paged pool, an optional radix prefix
cache, preemption by spill or recompute, shedding, and crash-consistent
snapshots).

The static path serves uniform-length prompt batches: one prefill over a
dense slab cache, then one decode step per new token; greedy, it is the
oracle the continuous engine is held against.  Its functions take
``model.prepare``d parameters and run on their device.

Admission pages an empty slot in; each tick then runs the model once over
the live slots.  A tick with a prefilling slot is *fused*: every slot gets
a (chunk,)-lane set, decoding slots sample their next token into lane 0
(n_valid = 1) and prefilling slots take the next chunk of their prompt.  A
tick where every live slot decodes takes the (num_slots, 1) decode step.
Parked slots get n_valid = 0: they neither write nor own blocks.

Sampling (temperature > 0, per request; None takes the engine's default)
is a counter-based Gumbel-max draw keyed on (seed, request id, absolute
position) in the engine and (seed, row, position) in ``generate``
(``serve/sampling.py``): part of the captured tick, identical on a reset
replay and on a recompute resume, independent of slot and batch.  T = 0 is
the argmax.  The draw cannot match ``jax.random``: tests compare
distributions with the reference, not tokens.

Compile-once ticks, as the reference's: a tick specializes only on its step
kind (fused or decode) and its horizon bucket, the smallest power of two of
block-table columns (capped at a slot's capacity) that covers the live
block horizon (``analysis/tracekeys.py``).  Its device state (held logits,
positions, active mask, temperatures, request ids, staged inputs per kind,
one contiguous table per bucket) is allocated once and updated in place, so
on the card each (kind, bucket) is captured into a CUDA graph at its first
tick and every later tick replays it (``serve/graphs.py``); on the CPU the
same tick runs eagerly.  ``generate``'s decode step is captured once per
(B, max_seq) the same way, its position a device scalar.  Everything that
writes the device state between ticks writes it in place: the pool's
forks, restores and scrubs, and a spilled request's held-logits row.

The tick reads paged KV through ``model.paged_read_path``: the GN paged
attention kernel, or the reference's streamed or gathered read when
``models.attention.FORCE_PAGED_READ`` forces one.  The engine fixes the path
at construction, reports it as ``metrics()["read_path"]`` and refuses to tick
after it changed, so no graph is replayed under another read.

Prefix sharing (``prefix_cache=True``): admission looks the prompt up in a
radix index of finished prompt prefixes (``serve/prefix_cache.py``), capped
at prompt_len - 1, attaches the fully matched blocks read-only, forks a
partially matched one, charges the reservation only for the unshared tail
and starts the prefill at the shared length.  Full prompt blocks are indexed
when their prefill completes, the partial prompt tail when the request
finishes.  Greedy tokens equal the unshared run's: only prompt KV, computed
by the same tick at the same positions, is shared.

The SLA control plane (``sched="priority"``, ``preempt``, ``aging_steps``,
``shed_backlog``): class-aware admission with an aging bound
(``PriorityScheduler``); an interactive head that cannot place evicts the
latest admitted batch request it outranks, which resumes later by re-
prefilling prompt + generated tokens (``"recompute"``) or by restoring its
spilled blocks, scales and held-logits row bit for bit (``"spill"``); and
arrived batch backlog past the watermark is rejected (``"rejected"``).
Every admit, resume, preempt, reject and finish lands in ``event_log``.

GN runtime sentinels (``sentinels=None`` = on, as the reference's): the
captured tick also computes a health word per live slot, the Σp residual of
every layer's read (+inf on nonfinite values; on the kernel read its
output's finiteness and its flag of a nonfinite score), the int8 clip
share, the scale sanity of the live horizon and the final norm's σ
residual, and it comes back in the tick's one device->host copy beside the
tokens.  The host checks it against the GN
bounds (``_sentinel_scan``): a violating slot's chain is scanned, its
corrupt blocks quarantined and scrubbed, and the request re-prefills prompt
+ generated tokens from the head of the queue (recompute resume), at most
``fault_retry_budget`` times before it finishes ``"failed"``.  A block
table that no longer matches its chain is repaired before the upload
(``_check_tables``); sustained int8 clipping finishes the request on the fp
static path (``_int8_fallback``).  Every verdict lands in ``event_log``.
``serve/faults.py`` injects the faults.

Per-tick host<->device traffic: the next tokens (and the health word) come
back in one copy; positions advance on the device; the active mask,
positions, temperatures, request ids and block tables are uploaded only
when admission, completion or block growth made their host mirrors dirty (a
bucket's table also when the tick first reads it after that); a fused tick
also uploads its staged chunk.

The slab pool (``paged=False``, and the automatic choice for a model
whose KV does not page: a sliding window, and the SSM and hybrid families):
``SlotKVPool`` holds one slab (or ring, or a layer's carries) a slot;
admission copies a fresh batch-1 cache into the slot (the mLSTM's
stabilizer at -1e30: ``model.fresh_request_cache``), spill copies the slot
out (``extract``) and a spill resume copies it back (``insert``); a
recompute resume re-prefills from a fresh cache.  A parked slot's carries
stay as they are (the reference ticks a free slot with token 0 at position
0, so its free slots' carries drift; admission overwrites a slot whole, so
neither is ever read).  Its ticks are the model's ``fused_step_slots`` and
``decode_step_slots``; on the card each step kind is one graph, keyed
(kind,).  As in the reference, the slab pool is fp-only, has no sentinels
(its default is off, ``sentinels=True`` is refused) and no prefix cache, and
takes no block size or block count.

Snapshots (``snapshot(path)``, ``restore(path)``): between ticks the engine
writes everything the next tick reads, in the reference's format
(``checkpoint/store.py``, leaves named as the reference's pytree names
them), so a snapshot of either package restores in the other.  Restore
writes in place into the arenas or slabs and into the graphs' static
buffers, so an engine with captured graphs resumes by replay.  The
sampler is keyed by counters, not by a PRNG key: the ``key`` leaf is
written as the reference's initial key for ``cfg.seed`` and ignored on
restore, so sampled resumes hold port to port only.

Encoder-decoder and VLM requests carry ``extras`` (``frames`` or
``patches``, numpy without a batch axis).  Admission turns them into the
slot's extra cache leaves (``model.request_extras``: the encoder runs once,
eagerly, outside any captured tick, and every layer's cross k and v are
projected; the VLM's patches are cast): into the slab slot with the fresh
cache, or into the paged pool's slot-batched ``extras``, which every tick
reads.  A recompute or spill resume writes them again.  The static path
stacks them into its batch, and snapshots carry them as the reference's
(``req/<id>/extras/<key>``, the cache's ``cross``/``patches`` leaves; the
SSM carries as ``layers/0..3`` or ``layers/0..1``, the hybrid's shared K/V
as ``shared/{k,v}``, as the reference's cache tuples).  The
prefix cache keys on tokens alone, as the reference's: two requests with
one prompt and other frames would share decoder blocks that depend on the
frames.

``kv_dtype="int8"`` serves over int8 arenas with per-block f32 scales
frozen at each block's first write.

Sharded serving (``devices=N``, the reference's slot-axis mesh): the pool
splits into N contiguous slot ranges, and paged into N block ranges, one a
device (``serve/kv_cache.py``), and the engine into N ``_Shard``s, each
with the prepared weights on its device (shards of one device share them),
its slice of the tick state (held logits, positions, active mask,
temperatures, request ids, staged inputs, bucket tables in its arenas'
local block ids) and its own ``StepGraphs``.  ``device`` names the one
device every shard takes (the CPU tests' ``"cpu"``, or one card), or is
None for ``cuda:0 .. cuda:N-1`` (``parallel/sharding.make_slot_mesh``).  A
tick stages every shard's inputs, launches every shard's tick (its graph
replay on the card) before it waits on any, then takes one device->host
copy a shard and assembles the tokens and health words in global slot
order.  The horizon bucket is the whole pool's, so every shard runs the
same key: one graph a shard a key.  Admission places a request on the
least-loaded device (most free slots, paged also a block range that
covers its reservation); a prefix hit pulls it to the device that holds
its blocks when that device can take it (one radix tree a device).  With
the sentinels on, a device whose every live slot (at least
``device_loss_min_slots``) violates in one tick is lost: its block range
is quarantined, its slots retired from admission, ``("device_lost", step,
d)`` logged, and its requests resume on the others.  Sharding changes
placement, never values: at f32 on the CPU the tokens and completions of
``devices=2`` equal ``devices=1``'s.  A MoE model's paged tick routes the
whole pool's N * C tokens, parked lanes included, as one GShard group, so
its shards tick in lockstep (``lockstep``): one thread a shard runs its
tick eagerly, and at each MoE layer every shard hands its router input to
a ``models.moe.TickExchange``, takes every shard's (a copy onto its own
device), routes the concatenation in slot order and applies the experts
to its own tokens; no shard captures a graph.  A slab tick routes each
slot's lanes as a group of their own, so a MoE model's slab shards tick
alone, graphed as any other.  With ``devices=1`` the engine is the
unsharded one: one shard, ``shards[0]``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import tracekeys
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import SCALE_SANITY_MAX
from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import make_slot_mesh
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_cache import BlockPagedKVPool, SlotKVPool
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import (Completion, FCFSScheduler, PriorityScheduler, Request,
                                         pad_to_grid)

# GN sentinel bounds (the reference's).  Σp residual: SENTINEL_SUM_SLACK ·
# (t + 1) · ε of the activation dtype, t the slot's attended width (the
# probe re-sums ε-rounded probabilities).  σ residual |mean(x̂²) − 1| of the
# final norm: the GN norms hold it to their grid (~1e-5); 1e-3 keeps two
# orders of headroom and still flags the O(1) deviations corruption makes.
SENTINEL_SUM_SLACK = 4.0
SENTINEL_SIGMA_BOUND = 1e-3


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0             # the sampler's counter seed


# ---------------------------------------------------------------- static ---
def _tokens_on(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(params["embed"]["tok"].device)


def _side_inputs(batch: dict) -> dict:
    """A batch's modality inputs (``frames``, ``patches``): every key but
    the tokens."""
    return {k: v for k, v in batch.items() if k != "tokens"}


# the cache's leaves that the reference's cache tree names otherwise than
# layers/<name>: the extra leaves, the SSM carries (its cache tuples, indexed:
# mLSTM conv, C, n, m; Mamba2 conv, h) and the hybrid's shared KV
_TREE_PATHS = {"cross_k": "cross/k", "cross_v": "cross/v", "patches": "patches",
               "conv": "layers/0", "C": "layers/1", "n": "layers/2", "m": "layers/3",
               "h": "layers/1", "shared_k": "shared/k", "shared_v": "shared/v"}


def _cache_tree_of(leaves: dict) -> dict:
    """Flat cache leaves (KV or carries, then extras) as the reference's
    cache tree: {"layers": {...}, "cross": {"k", "v"}}, {"layers",
    "patches"} or the hybrid's {"layers": {"0", "1"}, "shared": {"k", "v"}}."""
    tree: dict = {}
    for name, leaf in leaves.items():
        *outer, last = _leaf_path(name).split("/")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _leaf_path(name: str) -> str:
    """A flat cache leaf's path in the reference's cache tree."""
    return _TREE_PATHS.get(name, f"layers/{name}")


class _StaticDecode:
    """The static path's decode step over one slab cache of (B, max_seq):
    the token and the position are staged into device buffers, and the step
    runs eagerly on the CPU or as the replay of one CUDA graph on the card
    (the reference jits ``decode_step`` once, the position traced)."""

    def __init__(self, model: Model, params, batch: int, max_seq: int, device: torch.device):
        self.model, self.params = model, params
        self.cache = model.init_cache(batch, max_seq, device)
        self.token = torch.zeros(batch, 1, dtype=torch.int32, device=device)
        self.pos = torch.zeros((), dtype=torch.int32, device=device)
        self.graphs = StepGraphs(device) if device.type == "cuda" else None

    def _step(self):
        return self.model.decode_step(self.params, self.cache, self.token, self.pos)[0]

    def __call__(self, token, pos: int) -> torch.Tensor:
        """Logits (B, 1, V) of ``token`` (B, 1) at ``pos``; on the card they
        are the graph's output, overwritten by the next call."""
        self.token.copy_(token)
        self.pos.fill_(pos)
        if self.graphs is None:
            return self._step()
        # the warm-up is the step itself: it writes slot pos with the values
        # the replay then writes again, and puts the carries an SSM step
        # advances back as it found them
        return self.graphs.run(("decode",), self._step, self._warmup)

    def _warmup(self) -> None:
        kept = {k: self.cache[k].clone() for k in self.model.carry_leaves}
        self._step()
        for k, v in kept.items():
            self.cache[k].copy_(v)


def static_decoder(model: Model, params, batch: int, max_seq: int,
                   device: torch.device) -> _StaticDecode:
    """The decode step ``generate`` runs for (batch, max_seq).  On the card
    one is kept per (batch, max_seq) on the model, with its slab cache and
    graph, as the reference keeps its jits per model; a call with other
    parameters replaces it (the graph reads the weights it captured)."""
    if device.type != "cuda":
        return _StaticDecode(model, params, batch, max_seq, device)
    kept = model.__dict__.setdefault("_static_decoders", {})
    dec = kept.get((batch, max_seq))
    if dec is None or dec.params is not params:
        dec = kept[batch, max_seq] = _StaticDecode(model, params, batch, max_seq, device)
    return dec


def generate(model: Model, params, batch: dict, cfg: ServeConfig) -> torch.Tensor:
    """batch["tokens"]: (B, S_prompt) -> (B, S_prompt + max_new_tokens) int32
    tokens.  Prefill once into the decoder's slab cache, then
    ``max_new_tokens`` decode steps (graph replays on the card); as in the
    reference, the last step's logits are computed and not used.  Greedy at
    temperature 0; above it row b's token at position p is drawn from
    softmax(logits / T) keyed on (cfg.seed, b, p) (``serve/sampling.py``)."""
    tokens = _tokens_on(params, batch["tokens"])
    b, s = tokens.shape
    dev = tokens.device
    max_seq = s + cfg.max_new_tokens
    decode = static_decoder(model, params, b, max_seq, dev)
    logits, _ = model.prefill(params, {"tokens": tokens, **_side_inputs(batch)}, max_seq,
                              cache=decode.cache)
    last = logits[:, -1].clone()
    del logits
    out = torch.zeros(b, max_seq, dtype=torch.int32, device=dev)
    out[:, :s] = tokens
    rows = torch.arange(b, device=dev)
    temps = torch.full((b,), float(cfg.temperature), device=dev)
    for i in range(cfg.max_new_tokens):
        if cfg.temperature > 0:
            nxt = sample(last.float(), temps, cfg.seed, rows, torch.full_like(rows, s + i))
        else:
            nxt = last.argmax(dim=-1)
        nxt = nxt.to(torch.int32)[:, None]
        out[:, s + i:s + i + 1] = nxt
        last = decode(nxt, s + i)[:, 0]
    return out


def perplexity(model: Model, params, batch: dict) -> float:
    """Teacher-forced perplexity over a token batch (the score-oriented
    metric): the exact f32 log-softmax of the logits, as the reference's
    ``jax.nn.log_softmax``; ``frames`` or ``patches`` ride in ``batch``."""
    tokens = _tokens_on(params, batch["tokens"])
    logits = model.forward(params, {**batch, "tokens": tokens})[:, :-1].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return float(torch.exp(nll.mean()))


def static_reference(model: Model, params, requests: Sequence[Request],
                     cfg: ServeConfig) -> dict[int, np.ndarray]:
    """Serve ``requests`` through the static path: group by (prompt_len,
    max_new_tokens) in FCFS order, one ``generate`` call per group.  Returns
    request id -> full (prompt + generated) token array, truncated at a
    request's stop token if it has one (``generate`` itself always decodes
    the full budget).  The greedy-identity oracle of the continuous engine."""
    if any(r.temperature not in (None, 0, 0.0) for r in requests) or cfg.temperature:
        raise ValueError("static_reference is a greedy oracle (temperature 0 only)")
    groups: dict[tuple, list[Request]] = {}
    for req in requests:
        groups.setdefault((req.prompt_len, req.max_new_tokens), []).append(req)
    out: dict[int, np.ndarray] = {}
    for (plen, max_new), reqs in groups.items():
        batch = {"tokens": np.stack([np.asarray(r.tokens, np.int32) for r in reqs])}
        for k in reqs[0].extras:
            batch[k] = np.stack([np.asarray(r.extras[k]) for r in reqs])
        gcfg = dataclasses.replace(cfg, max_new_tokens=max_new)
        toks = generate(model, params, batch, gcfg).cpu().numpy()
        for r, row in zip(reqs, toks):
            if r.stop_token is not None:
                hits = np.nonzero(row[plen:] == r.stop_token)[0]
                if hits.size:
                    row = row[: plen + hits[0] + 1]
            out[r.id] = row
    return out


# ------------------------------------------------------------ continuous ---
# a Completion's fields a snapshot keeps beside its token arrays
_COMPLETION_FIELDS = ("request_id", "finish_reason", "arrival_step", "admit_step",
                      "first_token_step", "finish_step", "admit_time", "first_token_time",
                      "finish_time", "req_class", "preemptions")


def _plain(x):
    """``x`` with numpy scalars as Python numbers and tuples as lists (a
    snapshot's JSON manifest)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x.item() if isinstance(x, np.generic) else x


def _detuple(e):
    return tuple(_detuple(x) if isinstance(x, list) else x for x in e)


@dataclasses.dataclass
class _SlotState:
    req: Request
    admit_step: int
    admit_time: float
    generated: list
    padded: np.ndarray            # what prefill commits, padded to the chunk grid
    phase: str = "prefilling"     # 'prefilling' | 'decoding'
    written: int = 0              # prefill tokens committed to the cache
    # tokens the prefill commits before the slot decodes: the prompt, or for
    # a recompute resume the prompt and the tokens generated before it
    prefill_len: int = 0
    first_token_step: int = -1
    first_token_time: float = 0.0
    preemptions: int = 0          # times the request was evicted


@dataclasses.dataclass
class _Suspended:
    """An evicted request's state until admission takes it back.  ``spill``
    is None for a recompute resume (re-prefill prompt + ``generated``) and
    for a spill resume holds what the slot held: the chain's payload
    (``pool.extract_blocks``), the position, the prefill bookkeeping and
    the held-logits row."""
    generated: list
    admit_step: int
    admit_time: float
    first_token_step: int
    first_token_time: float
    preemptions: int
    spill: Optional[dict] = None


def round_slots_to_devices(num_slots: int, devices: int) -> int:
    """``num_slots`` rounded up to a multiple of ``devices``: the engine
    wants equal per-device slot ranges."""
    return -(-int(num_slots) // int(devices)) * int(devices)


class _Shard:
    """One device's share of a ``ContinuousEngine``: global slots [lo, lo + n)
    on ``device``, the prepared weights there, the pool's leaves of its
    range, and the tick's device state of its slots, allocated once and
    updated in place, so a graph captured from one tick reads and writes the
    same tensors on every replay.  Per step kind: chunk tokens, n_valid,
    is_prefill; per bucket: a contiguous (n, bucket) block table in the
    shard's local block ids.  On the card its ticks are graph replays of its
    own ``StepGraphs``; on the CPU they run eagerly."""

    def __init__(self, engine: "ContinuousEngine", index: int, device: torch.device, params):
        pool = engine.pool
        self.index, self.device, self.params = index, device, params
        self.model, self.sentinels, self.seed = engine.model, engine.sentinels, engine.cfg.seed
        n = pool.per_device_slots
        self.lo, self.n = index * n, n
        self.cache = pool.caches[index]
        self.extras = pool.extras_shards[index] if engine.paged else None
        dev = device
        self._last_logits = torch.zeros(n, self.model.cfg.vocab, dtype=torch.float32, device=dev)
        self._pos_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        self._temps_dev = torch.zeros(n, dtype=torch.float32, device=dev)
        self._rids_dev = torch.zeros(n, dtype=torch.int64, device=dev)  # the sampler's streams
        self._parked = torch.zeros(n, dtype=torch.bool, device=dev)  # the warm-up's mask
        self._inputs = {kind: (torch.zeros(n, c, dtype=torch.int32, device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev),
                               torch.zeros(n, dtype=torch.bool, device=dev))
                        for kind, c in (("fused", engine.chunk), ("decode", 1))}
        self._tables_dev = {b: torch.zeros(n, b, dtype=torch.int32, device=dev)
                            for b in engine.horizon_bucket_grid}
        # captured once per key and kept across reset, as the reference keeps
        # its compiled ticks
        self._graphs = StepGraphs(dev) if dev.type == "cuda" and not engine.lockstep else None

    def zero(self) -> None:
        for t in (self._last_logits, self._pos_dev, self._active_dev, self._temps_dev,
                  self._rids_dev):
            t.zero_()

    def _tick(self, active, kind, tokens, n_valid, is_prefill, tables):
        """Sample each decoding slot's token from the held logits into lane 0,
        run the model once, and update the held logits and positions in
        place.  Returns the sampled tokens (n,) int32, followed with
        sentinels by the health word's f32 bits (L * n * 3 + n), still on
        the device: one copy takes both.  With ``active`` all false (the
        warm-up before a capture) every lane is parked: nothing is written
        (paged writes go to the sink block), and the held logits and
        positions keep their values.  The slab pool (``tables`` None) runs
        the model's slab tick of ``kind``."""
        nxt = sample(self._last_logits, self._temps_dev, self.seed, self._rids_dev,
                     self._pos_dev)
        dec = torch.where(active & ~is_prefill, nxt, 0).to(torch.int32)
        lane0 = torch.zeros_like(tokens)
        lane0[:, 0] = dec
        tokens = torch.where(is_prefill[:, None], tokens, lane0)
        nv = torch.where(active, torch.where(is_prefill, n_valid, 1), 0).to(torch.int32)
        pos = torch.where(active, self._pos_dev, 0).to(torch.int32)
        if tables is None and kind == "decode":
            out = self.model.decode_step_slots(self.params, self.cache, tokens, pos, active)
        elif tables is None:
            out = self.model.fused_step_slots(self.params, self.cache, tokens, pos, nv)
        else:
            out = self.model.fused_step_slots_paged(self.params, self.cache, tokens, pos, nv,
                                                    tables, sentinel=self.sentinels,
                                                    extras=self.extras)
        logits, health = out if self.sentinels else (out, None)
        self._last_logits.copy_(torch.where(active[:, None], logits[:, 0].float(),
                                            self._last_logits))
        self._pos_dev.add_(nv)
        if health is None:
            return dec
        return torch.cat([dec, health["layers"].flatten().view(torch.int32),
                          health["head"].view(torch.int32)])

    def run_tick(self, kind: str, bucket: Optional[int]):
        """The tick of ``kind`` over the ``bucket``-wide tables (None: the
        slab pool): eagerly on the CPU, on the card the replay (launched,
        not waited on) of the graph keyed (kind, bucket) or, slab, (kind,)."""
        args = (kind, *self._inputs[kind],
                None if bucket is None else self._tables_dev[bucket])
        if self._graphs is None:
            return self._tick(self._active_dev, *args)
        key = (kind,) if bucket is None else (kind, bucket)
        return self._graphs.run(key, lambda: self._tick(self._active_dev, *args),
                                lambda: self._tick(self._parked, *args))


class ContinuousEngine:
    def __init__(self, model: Model, params, num_slots: int, max_seq: int,
                 cfg: ServeConfig = ServeConfig(), chunk: int = 8, block_size: int = 0, num_blocks: int = 0,
                 devices: int = 1, paged: Optional[bool] = None,
                 prefix_cache: bool = False, sched: str = "fcfs", preempt: str = "off",
                 aging_steps: int = 64, shed_backlog: int = 0,
                 kv_dtype: str = "fp", sentinels: Optional[bool] = None,
                 fault_retry_budget: int = 3, clip_fallback_frac: float = 0.5,
                 clip_patience: int = 3, device_loss_min_slots: int = 2, device=None):
        # the SLA control plane, as the reference's: the policy is an engine
        # argument so reset() rebuilds an equal scheduler; preemption needs
        # the priority policy (its victims are chosen by the rank rule, and
        # under FCFS a requeued victim would head the queue again)
        if sched not in ("fcfs", "priority"):
            raise ValueError(f"sched must be 'fcfs' or 'priority', got {sched!r}")
        if preempt not in ("off", "recompute", "spill"):
            raise ValueError(f"preempt must be 'off', 'recompute' or 'spill', got {preempt!r}")
        if preempt != "off" and sched != "priority":
            raise ValueError("preempt requires sched='priority': victim eligibility is the "
                             "priority rank rule")
        self.sched_policy, self.preempt_mode = sched, preempt
        self.aging_steps, self.shed_backlog = int(aging_steps), int(shed_backlog)
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        self.model, self.cfg = model, cfg
        self.num_slots, self.max_seq = int(num_slots), int(max_seq)
        self.chunk = int(chunk)
        win = model.cfg.sliding_window or 0
        limit = min(self.max_seq, win) if win else self.max_seq
        if not 1 <= self.chunk <= limit:
            raise ValueError(f"chunk {chunk} must be in [1, {limit}] "
                             "(cache ring capacity bounds the per-tick chunk)")
        # the shards, as the reference's slot mesh: one device (devices=1: the
        # unsharded engine), N cards, or N shards of one given device
        self.num_devices = int(devices)
        if self.num_devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if self.num_slots % self.num_devices:
            raise ValueError(f"num_slots {num_slots} must divide evenly over {devices} "
                             "devices (per-device slot shards)")
        self.shard_devices = ([resolve_device(device)] if self.num_devices == 1
                              else make_slot_mesh(self.num_devices, device))
        self.device = self.shard_devices[0]
        # the pool, as the reference picks it: block-paged wherever the KV
        # pages, the slab pool for a sliding window's ring (or when asked)
        self.paged = model.supports_paging if paged is None else bool(paged)
        if self.paged and not model.supports_paging:
            raise ValueError(f"family {model.cfg.family!r} (sliding_window="
                             f"{model.cfg.sliding_window}) has no pageable KV")
        if kv_dtype == "int8" and not self.paged:
            raise ValueError("kv_dtype='int8' requires the block-paged pool (per-block scales "
                             "live in the block tables); the slab pool is fp-only")
        # the paged tick routes the whole pool's N * C tokens as one GShard
        # group: a MoE model's shards tick in lockstep (``_lockstep_ticks``)
        self.lockstep = (self.num_devices > 1 and model.cfg.moe is not None
                         and self.paged)
        # GN runtime sentinels, on unless asked off over the paged pool (the
        # reference's default); the slab pool has no probe path.  The retry
        # budget, the int8 clip watchdog, and the device-loss floor: the live
        # slots of one device that must all violate in one tick
        self.sentinels = self.paged if sentinels is None else bool(sentinels)
        if self.sentinels and not self.paged:
            raise ValueError("sentinels ride the paged tick bodies; the slab pool has no probe "
                             "path (pass sentinels=False or paged=True)")
        self.fault_retry_budget = int(fault_retry_budget)
        self.clip_fallback_frac = float(clip_fallback_frac)
        self.clip_patience = int(clip_patience)
        self.device_loss_min_slots = int(device_loss_min_slots)
        # the prepared weights, one replica a device the shards sit on
        replicas = {}
        for dev in self.shard_devices:
            if dev not in replicas:
                replicas[dev] = model.prepare(params, dev)
        self.params = replicas[self.device]
        if self.paged:
            # the paged read every tick takes, fixed here: a graph captured
            # under one read is never replayed under another (``step``
            # refuses a change)
            self.read_path = model.paged_read_path
            self.pool = BlockPagedKVPool(model, num_slots, max_seq, block_size or self.chunk,
                                         num_blocks, self.shard_devices, kv_dtype)
            # the radix prefix index, one tree a device (opt-in: a retaining
            # cache keeps blocks resident after a drain)
            self.prefix = (PrefixCache(self.pool.block_size, self.num_devices)
                           if prefix_cache else None)
            if self.prefix is not None:
                self.pool.attach_prefix_cache(self.prefix)
            # the horizon-bucket grid, as the reference's: each tick reads the
            # smallest power-of-two bucket of block-table columns that covers
            # the live block horizon, so a tick has one shape per (kind, bucket)
            self.horizon_bucket_grid = tracekeys.horizon_bucket_grid(self.max_seq,
                                                                     self.pool.block_size)
        else:
            if prefix_cache:
                raise ValueError(f"family {model.cfg.family!r} has no pageable KV; "
                                 "prefix_cache shares paged blocks")
            if block_size or num_blocks:
                raise ValueError(
                    f"family {model.cfg.family!r} has no pageable KV; block_size/num_blocks "
                    "only apply to paged pools" if not model.supports_paging else
                    "block_size/num_blocks only apply to paged pools (paged=False forces "
                    "the slab pool)")
            self.read_path, self.prefix, self.horizon_bucket_grid = "slab", None, []
            self.pool = SlotKVPool(model, num_slots, max_seq, self.shard_devices)
            # the batch-1 cache admission copies into a slot
            self._fresh = model.fresh_request_cache(self.max_seq, self.device)
        self.kv_dtype = kv_dtype
        self.shards = [_Shard(self, d, dev, replicas[dev])
                       for d, dev in enumerate(self.shard_devices)]
        self.reset()

    def _shard_of(self, slot: int) -> _Shard:
        return self.shards[int(slot) // self.pool.per_device_slots]

    def _held_row(self, slot: int) -> torch.Tensor:
        """Global ``slot``'s row of its shard's held logits (a view)."""
        sh = self._shard_of(slot)
        return sh._last_logits[int(slot) - sh.lo]

    def held_logits(self) -> torch.Tensor:
        """Every slot's held logits (num_slots, vocab) f32 in global slot
        order: the one shard's tensor at ``devices=1``, else a CPU copy."""
        if self.num_devices == 1:
            return self.shards[0]._last_logits
        return torch.cat([sh._last_logits.cpu() for sh in self.shards])

    def reset(self) -> None:
        """Clear all serving state but keep the weights and the pool's arenas;
        slot and block order are restored, so a reset run replays a workload
        with identical slot assignment, block tables and sampled tokens."""
        self.pool.reset()
        n = self.num_slots
        for sh in self.shards:
            sh.zero()
        self._temps = np.zeros(n, np.float32)  # host mirrors of the sampler's state
        self._rids = np.zeros(n, np.int64)
        self._tables_fresh: set[int] = set()  # buckets whose buffer holds the host tables
        self._lanes_dirty = True
        self._slots: list[Optional[_SlotState]] = [None] * n
        self.scheduler = self._make_scheduler()
        self.step_count = 0
        self.completions: list[Completion] = []
        self.model_ticks = 0      # ticks that ran the model
        self._replayed_ticks = 0  # ... of which as a graph replay
        self.fused_ticks = 0      # ... of which carried a prefill lane
        self.generated_tokens = 0
        # admissions and resumes a device: the balance least-loaded placement keeps
        self._device_admits = np.zeros(self.num_devices, np.int64)
        # the reference's occupancy counters, summed over model ticks: live
        # slots, prefilling slots, and attended columns (bucket * block size)
        self._active_steps = 0
        self._prefill_lane_steps = 0
        self._attended_tokens = 0
        # (prefill lanes, decode lanes, host seconds) per model tick; the
        # reference's (prefill, decode) lanes and, paged, (horizon, bucket)
        self.tick_log: list[tuple[int, int, float]] = []
        self.phase_log: list[tuple[int, int]] = []
        self.horizon_log: list[tuple[int, int]] = []
        # the horizon buckets each step kind ran at since the reset
        self._buckets_seen: dict[str, set] = {"fused": set(), "decode": set()}
        # the deterministic event trace (admit, resume, finish, and every
        # sentinel verdict, each with its step), as the reference's
        self.event_log: list[tuple] = []
        self._suspended: dict[int, _Suspended] = {}
        self._preemptions = 0
        self._resumes = 0
        self._rejections = 0
        # prefix sharing (pool.reset() cleared the index): cached prompt
        # tokens, admitted prompt tokens, hitting requests, and per request
        # its hit {tokens, blocks, forked, device}
        self._prefix_hit_tokens = 0
        self._prefix_prompt_tokens = 0
        self._prefix_hit_requests = 0
        self.request_prefix_hits: dict[int, dict] = {}
        self._sentinel_checks = 0
        self._sentinel_violations = 0
        self._retries = 0
        self._fallbacks = 0
        self._table_repairs = 0
        self._fault_retries: dict[int, int] = {}
        self._clip_streak = np.zeros(n, np.int32)
        # the largest finite Σp and σ residuals checked: the margin to the bounds
        self._peak = {"sum": 0.0, "sigma": 0.0}

    def _make_scheduler(self) -> FCFSScheduler:
        """The scheduler of the engine's policy, built anew on every reset."""
        if self.sched_policy == "priority":
            return PriorityScheduler(chunk_grid=self.chunk, prefix_cache=self.prefix,
                                     aging_steps=self.aging_steps,
                                     shed_backlog=self.shed_backlog)
        return FCFSScheduler(chunk_grid=self.chunk, prefix_cache=self.prefix)

    def submit(self, req: Request) -> int:
        return self.scheduler.submit(req)

    # ------------------------------------------------------------ admission --
    def _admit(self) -> None:
        """Page empty slots in for ready requests (no forward pass: the fused
        tick drains each prompt chunk by chunk).  Shedding first; then per
        head: a prefix lookup (fresh requests only), which pulls the request
        to the device holding its blocks if that device can take it, else
        placement on the least-loaded device, or an interactive head's
        preemption of a batch victim, or the head waits."""
        self._tick_admitted: set[int] = set()  # slots filled this pass
        live_units, unit_fn = self._shed_signal()
        for req in self.scheduler.poll_shed(self.step_count, live_units, unit_fn):
            self._reject(req)
        while True:
            head = self.scheduler.peek_ready(self.step_count)
            if head is None:
                break
            footprint = head.prompt_len + head.max_new_tokens
            if footprint > self.max_seq:
                raise ValueError(f"request {head.id}: prompt {head.prompt_len} + "
                                 f"{head.max_new_tokens} new tokens exceeds max_seq {self.max_seq}")
            if self.paged and self.pool.blocks_for(footprint) > self.pool.max_request_blocks:
                raise ValueError(f"request {head.id}: footprint {footprint} tokens needs "
                                 f"{self.pool.blocks_for(footprint)} blocks, a device's "
                                 f"arena has {self.pool.max_request_blocks} — unservable at "
                                 "any occupancy")
            # a resuming request skips the lookup: a spill rebuilds the exact
            # chain its payload came from, and a recompute re-prefills prompt
            # + generated tokens, which the prompt-only index does not cover
            hit = device = None
            resuming = head.id in self._suspended
            if self.prefix is not None and not resuming:
                # capped at prompt_len - 1: the first sampled token needs the
                # request's own last prompt position to run through prefill
                hit = self.prefix.lookup(head.tokens, cap=head.prompt_len - 1)
                if hit is not None:
                    if (self.pool.free_slots_on(hit.device)
                            and self.pool.can_reserve(footprint, hit.device, prefix=hit)):
                        device = hit.device
                    else:
                        hit = None
            if device is None and self.pool.num_free:
                device = self.pool.pick_device(footprint if self.paged else 0)
            if device is None:
                # no device has a free slot AND the whole reservation: the head
                # waits, unless it may evict a batch victim it outranks
                if self._try_preempt(head):
                    continue
                break
            req = self.scheduler.pop_ready(self.step_count)
            sus = self._suspended.pop(req.id, None)
            slot = (self.pool.allocate(reserve_tokens=footprint, device=device, prefix=hit)
                    if self.paged else self.pool.allocate(device=device))
            self._device_admits[device] += 1
            if hit is not None:
                self.pool.attach_prefix(slot, hit)
            if sus is not None and sus.spill is not None:
                # spill resume: a fresh chain of the spilled length filled
                # with the payload (other physical ids, same logical order),
                # or the slab copied back; the held-logits row written back
                # in place
                sp = sus.spill
                if self.paged:
                    self.pool.insert(slot, sp["position"])
                    self.pool.insert_extras(slot, self.model.request_extras(
                        self._shard_of(slot).params, req.extras))
                    self.pool.restore_blocks(slot, sp["kv"])
                else:
                    self.pool.insert(sp["kv"], slot, sp["position"])
                self._held_row(slot).copy_(sp["last_logits"])
                padded, written = sp["padded"], sp["written"]
                phase, prefill_len = sp["phase"], sp["prefill_len"]
            elif sus is not None:
                # recompute resume: prefill prompt + generated anew; chunked
                # prefill is token-identical to the decode that made them, so
                # the held logits end where the uninterrupted run's were
                seq = np.concatenate([np.asarray(req.tokens, np.int32),
                                      np.asarray(sus.generated, np.int32)])
                padded, prefill_len = pad_to_grid(seq, self.chunk), int(seq.shape[0])
                self._insert_fresh(slot, 0, req)
                written, phase = 0, "prefilling"
            else:
                shared = hit.shared_len if hit is not None else 0
                self._insert_fresh(slot, shared, req)
                padded = req.padded_tokens
                if shared:
                    # the prefill starts at the shared length, so its chunks
                    # run [shared + k * chunk, ... + chunk): pad the prompt to
                    # cover the last one (the intake's grid padding falls
                    # short when shared is not chunk-aligned)
                    need = shared + -(-(req.prompt_len - shared) // self.chunk) * self.chunk
                    if padded.shape[0] < need:
                        padded = np.concatenate([np.asarray(req.tokens, np.int32),
                                                 np.zeros(need - req.prompt_len, np.int32)])
                    self._prefix_hit_tokens += shared
                    self._prefix_hit_requests += 1
                    self.request_prefix_hits[req.id] = {
                        "tokens": shared, "blocks": len(hit.blocks),
                        "forked": hit.tail_src is not None, "device": hit.device}
                written, phase, prefill_len = shared, "prefilling", req.prompt_len
            if self.prefix is not None and not resuming:
                self._prefix_prompt_tokens += req.prompt_len
            temp = self.cfg.temperature if req.temperature is None else req.temperature
            self._temps[slot], self._rids[slot] = float(temp), req.id
            self._slots[slot] = _SlotState(
                req=req, admit_step=sus.admit_step if sus else self.step_count,
                admit_time=sus.admit_time if sus else time.time(),
                generated=sus.generated if sus else [], padded=padded, phase=phase,
                written=written, prefill_len=prefill_len,
                first_token_step=sus.first_token_step if sus else -1,
                first_token_time=sus.first_token_time if sus else 0.0,
                preemptions=sus.preemptions if sus else 0)
            self._lanes_dirty = True
            self._clip_streak[slot] = 0
            self._tick_admitted.add(slot)
            if sus is not None:
                self._resumes += 1
            self.event_log.append(("resume" if sus else "admit", self.step_count, req.id, slot,
                                   device))

    def _insert_fresh(self, slot: int, position: int, req: Request) -> None:
        """Start an admitted slot at ``position``: its chain ensured over
        the paged pool, a fresh batch-1 cache copied into its slab; and the
        request's extra leaves (``model.request_extras``) written in."""
        extras = self.model.request_extras(self._shard_of(slot).params, req.extras)
        if self.paged:
            self.pool.insert(slot, position)
            self.pool.insert_extras(slot, extras)
        else:
            self.pool.insert({**self._fresh, **extras}, slot, position)

    def _shed_signal(self) -> tuple:
        """(live reservation, a request's footprint) in the pool's admission
        units, blocks or slots: the scheduler's shedding watermark reads
        them."""
        if not self.paged:
            return self.pool.num_used, lambda r: 1
        return (self.pool.blocks_reserved,
                lambda r: self.pool.blocks_for(r.prompt_len + r.max_new_tokens))

    def _try_preempt(self, head: Request) -> bool:
        """Evict one batch victim so the interactive ``head`` can place: the
        latest admitted live batch slot the head outranks under the
        scheduler's rank rule (an aged victim is immune: no admit/preempt
        livelock), never one admitted in this pass."""
        if self.preempt_mode == "off" or head.req_class != "interactive":
            return False
        best = None
        for s, st in enumerate(self._slots):
            if (st is None or st.req.req_class != "batch" or s in self._tick_admitted
                    or not self.scheduler.outranks(head.arrival_step, st.req.arrival_step)):
                continue
            if best is None or (st.admit_step, s) > (self._slots[best].admit_step, best):
                best = s
        if best is None:
            return False
        self._preempt(best)
        return True

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request to the head of its class.  Spill copies
        the chain (arenas and scales), the held-logits row and the prefill
        bookkeeping to the host first; recompute drops the chain.  The freed
        blocks are recycled unzeroed: under GN an eviction edits tables and
        lengths, never memory."""
        st = self._slots[slot]
        rid = st.req.id
        spill = None
        if self.preempt_mode == "spill":
            kv = (self.pool.extract_blocks(slot) if self.paged
                  else {k: v.cpu() for k, v in self.pool.extract(slot).items()})
            spill = {"kv": kv,
                     "position": int(self.pool.positions[slot]), "padded": st.padded,
                     "written": st.written, "prefill_len": st.prefill_len, "phase": st.phase,
                     "last_logits": self._held_row(slot).to("cpu", copy=True)}
        self._suspended[rid] = _Suspended(
            generated=st.generated, admit_step=st.admit_step, admit_time=st.admit_time,
            first_token_step=st.first_token_step, first_token_time=st.first_token_time,
            preemptions=st.preemptions + 1, spill=spill)
        self._slots[slot] = None
        self.pool.free(slot)
        self.scheduler.requeue_front(st.req)
        self._preemptions += 1
        self._lanes_dirty = True
        self.event_log.append(("preempt", self.step_count, rid, self.preempt_mode, slot))

    def _reject(self, req: Request) -> None:
        """A shed request's completion: finish_reason 'rejected'."""
        now = time.time()
        self.completions.append(Completion(
            request_id=req.id, prompt_tokens=np.asarray(req.tokens, np.int32),
            new_tokens=np.zeros(0, np.int32), finish_reason="rejected",
            arrival_step=req.arrival_step, admit_step=-1, first_token_step=-1,
            finish_step=self.step_count, admit_time=now, first_token_time=now,
            finish_time=now, req_class=req.req_class, preemptions=0))
        self._rejections += 1
        self.event_log.append(("reject", self.step_count, req.id))

    def _prefix_insert(self, slot: int, up_to: int) -> None:
        """Index ``slot``'s prompt prefix [0, up_to) in the radix cache: its
        full blocks when the prefill completes, its partial tail when the
        request finishes.  Generated tokens are never indexed."""
        if up_to > 0:
            self.prefix.insert(np.asarray(self._slots[slot].req.tokens[:up_to], np.int32),
                               self.pool.chain_of(slot)[:self.pool.blocks_for(up_to)],
                               self.pool.device_of(slot))

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        # a recompute-resumed slot prefilled prompt + generated, but its
        # first blocks_for(prompt_len) blocks still hold the prompt's KV
        if (self.prefix is not None and st.written >= st.req.prompt_len
                and st.req.prompt_len % self.pool.block_size):
            self._prefix_insert(slot, st.req.prompt_len)
        self.completions.append(Completion(
            request_id=st.req.id,
            prompt_tokens=np.asarray(st.req.tokens, np.int32),
            new_tokens=np.asarray(st.generated, np.int32),
            finish_reason=reason,
            arrival_step=st.req.arrival_step,
            admit_step=st.admit_step,
            first_token_step=st.first_token_step,
            finish_step=self.step_count,
            admit_time=st.admit_time,
            first_token_time=st.first_token_time,
            finish_time=time.time(),
            req_class=st.req.req_class,
            preemptions=st.preemptions,
        ))
        self.event_log.append(("finish", self.step_count, st.req.id, reason))
        self._slots[slot] = None
        self.pool.free(slot)
        self._lanes_dirty = True

    # ------------------------------------------------------ fault tolerance --
    def _check_tables(self) -> None:
        """The block tables' redundancy check, before the upload: a live
        slot's chain is the allocation record and its table row is derived
        from it; a row that differs is repaired from the chain, counted and
        logged, so a scribbled entry never reaches the device."""
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            chain = self.pool.chain_of(s)
            if chain and not np.array_equal(self.pool.tables[s, :len(chain)], chain):
                self.pool.tables[s, :len(chain)] = chain
                self.pool.tables_dirty = True
                self._table_repairs += 1
                self._sentinel_violations += 1
                self.event_log.append(("fault_table_repair", self.step_count, st.req.id, s))

    def _sentinel_scan(self, health: dict, live: list[int]) -> None:
        """Check each live slot's health word against the GN bounds and
        contain what violates (the reference's ``_sentinel_scan``).

        * layers[:, s, 0], the Σp residual: at most SENTINEL_SUM_SLACK ·
          (t + 1) · ε with t the slot's attended width (NaN-safe: a
          violation is ``not (x <= bound)``);
        * head[s], the final norm's σ residual: at most SENTINEL_SIGMA_BOUND
          for the GN and exact norms, finite for the others;
        * layers[:, s, 2], scale sanity: 0;
        * layers[:, s, 1], the int8 clip share, on a clean tick: above
          ``clip_fallback_frac`` for ``clip_patience`` ticks in a row moves
          the request to the fp static path (a range problem, not a fault).

        A violating slot's chain is scanned, its corrupt blocks quarantined
        and scrubbed, and the request evicted to re-prefill prompt +
        generated tokens, or finished "failed" once its retry budget is
        spent.  Before that, over several devices: a device whose every live
        slot (at least ``device_loss_min_slots``) violates in this tick is
        lost (``pool.mark_device_lost``): flaky hardware, not corrupt
        blocks."""
        layers, head = health["layers"].astype(np.float64), health["head"].astype(np.float64)
        cfg = self.model.cfg
        sigma_certified = cfg.norm_impl.startswith(("gn", "exact"))
        eps = torch.finfo(getattr(torch, cfg.dtype)).eps
        violating: dict[int, list] = {}
        for s in live:
            if self._slots[s] is None:
                continue
            self._sentinel_checks += 1
            kinds = []
            bound = SENTINEL_SUM_SLACK * (int(self.pool.positions[s]) + 1) * eps
            sumres = layers[:, s, 0]
            worst = float(np.max(sumres))
            if not worst <= bound:
                kinds.append(("sum", int(np.argmin(sumres <= bound)), worst))
            h = float(head[s])
            for key, val in (("sum", worst), ("sigma", h)):
                if np.isfinite(val):
                    self._peak[key] = max(self._peak[key], val)
            if (not h <= SENTINEL_SIGMA_BOUND) if sigma_certified else not np.isfinite(h):
                kinds.append(("sigma", -1, h))
            scl = layers[:, s, 2]
            if not float(np.max(scl)) <= 0.0:
                kinds.append(("scale", int(np.argmax(scl)), float(np.max(scl))))
            if kinds:
                violating[s] = kinds
            elif self.pool.kv_dtype == "int8":
                if float(np.max(layers[:, s, 1])) > self.clip_fallback_frac:
                    self._clip_streak[s] += 1
                    if self._clip_streak[s] >= self.clip_patience:
                        self._int8_fallback(s)
                else:
                    self._clip_streak[s] = 0
        if not violating:
            return
        self._sentinel_violations += len(violating)
        # device-loss aggregation, before eviction changes residency
        if self.num_devices > 1:
            for d in range(self.num_devices):
                if d in self.pool._lost_devices:
                    continue
                live_d = [s for s in live if self.pool.device_of(s) == d
                          and self._slots[s] is not None]
                viol_d = [s for s in violating if self.pool.device_of(s) == d]
                if len(viol_d) >= self.device_loss_min_slots and len(viol_d) == len(live_d):
                    self.pool.mark_device_lost(d)
                    self.event_log.append(("device_lost", self.step_count, d))
        # quarantine and scrub the blocks that are corrupt; a flagged slot
        # with a clean chain read a poisoned block through a stale entry and
        # recovers the same way, its own blocks recycled as usual
        bad: set[int] = set()
        for s in violating:
            bad |= self._diagnose_chain(s)
        for b in sorted(bad):
            self.pool.quarantine_block(b)
            self.event_log.append(("quarantine", self.step_count, b))
        self.pool.scrub_blocks(bad)
        for s, kinds in violating.items():
            rid = self._slots[s].req.id
            self.event_log.append(("fault", self.step_count, rid, s,
                                   tuple(k for k, _, _ in kinds),
                                   tuple(lay for _, lay, _ in kinds)))
            n = self._fault_retries.get(rid, 0)
            if n >= self.fault_retry_budget:
                self._finish(s, "failed")
            else:
                self._fault_retries[rid] = n + 1
                self._retries += 1
                self._fault_evict(s)

    def _diagnose_chain(self, slot: int) -> set:
        """The physical blocks of ``slot``'s chain that are corrupt: fp arena
        tiles holding a nonfinite value, or int8 scales that are nonfinite,
        negative or past SCALE_SANITY_MAX.  An int8 tile cannot hold NaN,
        and a finite wrong value is below the GN floor by design."""
        chain = self.pool.chain_of(slot)
        if not chain:
            return set()
        d = self.pool.device_of(slot)
        off = d * self.pool.blocks_per_device
        ix = torch.tensor([b - off for b in chain], dtype=torch.long,
                          device=self.pool.devices[d])
        hit = torch.zeros(len(chain), dtype=torch.bool)
        for name, leaf in self.pool.caches[d].items():
            a = leaf.index_select(1, ix).cpu()
            if name.endswith("_scale"):
                f = a.double()
                hit |= (~torch.isfinite(f) | (f < 0) | (f > SCALE_SANITY_MAX)).any(dim=0)
            elif a.dtype != torch.int8:
                hit |= ~torch.isfinite(a.float().flatten(2)).all(dim=2).all(dim=0)
        return {b for b, h in zip(chain, hit.tolist()) if h}

    def _fault_evict(self, slot: int) -> None:
        """Free a flagged slot and requeue its request at the head: it
        resumes by re-prefilling prompt + generated (recompute resume); its
        doomed blocks go to quarantine as the slot is freed."""
        st = self._slots[slot]
        rid = st.req.id
        self._suspended[rid] = _Suspended(
            generated=st.generated, admit_step=st.admit_step, admit_time=st.admit_time,
            first_token_step=st.first_token_step, first_token_time=st.first_token_time,
            preemptions=st.preemptions + 1)
        self._slots[slot] = None
        self.pool.free(slot)
        self.scheduler.requeue_front(st.req)
        self._lanes_dirty = True
        self.event_log.append(("fault_evict", self.step_count, rid, slot))

    def _int8_fallback(self, slot: int) -> None:
        """Sustained int8 clipping: finish the request on the fp static path,
        which prefills prompt + generated and decodes the rest greedily (a
        sampled request too, as the reference's), then free the slot."""
        st = self._slots[slot]
        req = st.req
        self._fallbacks += 1
        self.event_log.append(("kv_fallback", self.step_count, req.id, slot))
        seq = np.concatenate([np.asarray(req.tokens, np.int32),
                              np.asarray(st.generated, np.int32)])
        remaining = req.max_new_tokens - len(st.generated)
        reason = "length"
        if remaining > 0:
            gcfg = dataclasses.replace(self.cfg, max_new_tokens=remaining, temperature=0.0)
            batch = {"tokens": seq[None],
                     **{k: np.asarray(v)[None] for k, v in req.extras.items()}}
            row = generate(self.model, self._shard_of(slot).params, batch,
                           gcfg)[0].cpu().numpy()
            gen = list(st.generated)
            for tok in row[seq.shape[0]:]:
                gen.append(int(tok))
                if req.stop_token is not None and int(tok) == req.stop_token:
                    reason = "stop"
                    break
            st.generated = gen
        self._finish(slot, reason)

    # ----------------------------------------------------------------- ticks --
    def _run_tick(self, kind: str, bucket: Optional[int], d: int = 0):
        """Shard ``d``'s tick of ``kind`` over the ``bucket``-wide tables (None:
        the slab pool), launched and not waited on: its output (tokens, then
        the health words), on its device."""
        return self.shards[d].run_tick(kind, bucket)

    def _lockstep_ticks(self, kind: str, bucket: Optional[int]) -> list:
        """Every shard's eager tick at once, one thread a shard, in lockstep
        at each MoE layer (``moe.TickExchange``): their outputs in shard
        order.  A shard that raises breaks the others' wait, and its error
        is raised here."""
        exchange = moe_mod.TickExchange(self.num_devices)
        outs, errors = [None] * self.num_devices, [None] * self.num_devices

        def run(d: int) -> None:
            try:
                with exchange.shard(d):
                    outs[d] = self._run_tick(kind, bucket, d)
            except BaseException as e:  # noqa: BLE001 -- raised below, in this thread
                errors[d] = e

        threads = [threading.Thread(target=run, args=(d,)) for d in range(self.num_devices)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:  # the first cause, not a barrier another shard broke
            raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        return outs

    def step(self) -> bool:
        """One engine tick.  Returns False once fully drained."""
        if self.paged and self.model.paged_read_path != self.read_path:
            raise RuntimeError(
                f"this engine was built to read paged KV through {self.read_path!r}, and "
                f"FORCE_PAGED_READ now asks for {self.model.paged_read_path!r}: its ticks and "
                "graphs read one path; build a new engine for another")
        if self.sentinels:
            self._check_tables()  # before the tables can reach the device
        self._admit()
        live = [s for s, st in enumerate(self._slots) if st is not None]
        if not live:
            if self.scheduler.has_pending():
                # idle fast-forward to the next arrival: nothing observable
                # can happen on the skipped ticks
                self.step_count = max(self.step_count + 1, self.scheduler.next_ready_step())
                return True
            return False
        t0 = time.perf_counter()
        prefills = [s for s in live if self._slots[s].phase == "prefilling"]
        decoders = [s for s in live if self._slots[s].phase == "decoding"]
        if self._lanes_dirty:  # residency changed: refresh the device mirrors
            active = np.array([st is not None for st in self._slots])
            for sh in self.shards:
                rows = slice(sh.lo, sh.lo + sh.n)
                for buf, host in ((sh._active_dev, active), (sh._pos_dev, self.pool.positions),
                                  (sh._temps_dev, self._temps), (sh._rids_dev, self._rids)):
                    buf.copy_(torch.from_numpy(host[rows]))
            self._lanes_dirty = False
        takes = {s: min(self.chunk, self._slots[s].prefill_len - self._slots[s].written)
                 for s in prefills}
        kind = "fused" if prefills else "decode"
        bucket = self._paged_tables(live, takes, kind) if self.paged else None
        if prefills:  # stage the chunk; the decode step's inputs stay zero
            chunk_toks = np.zeros((self.num_slots, self.chunk), np.int32)
            n_valid = np.ones(self.num_slots, np.int32)
            is_pref = np.zeros(self.num_slots, bool)
            for s in prefills:
                st = self._slots[s]
                chunk_toks[s] = st.padded[st.written: st.written + self.chunk]
                n_valid[s] = takes[s]
                is_pref[s] = True
            for sh in self.shards:
                rows = slice(sh.lo, sh.lo + sh.n)
                for buf, host in zip(sh._inputs[kind], (chunk_toks, n_valid, is_pref)):
                    buf.copy_(torch.from_numpy(host[rows]))
            self.fused_ticks += 1
        if self.shards[0]._graphs is not None:
            self._replayed_ticks += 1
        # every shard's tick is launched before any is waited on; then one
        # device->host copy a shard, assembled in global slot order
        outs = (self._lockstep_ticks(kind, bucket) if self.lockstep
                else [self._run_tick(kind, bucket, d) for d in range(self.num_devices)])
        toks, health = self._assemble([o.cpu().numpy() for o in outs])
        self.pool.advance({s: takes.get(s, 1) for s in live})
        self.model_ticks += 1
        self.phase_log.append((len(prefills), len(decoders)))
        # every decoding lane's token, as the reference counts them: a token
        # the sentinel scan below discards is counted too
        self.generated_tokens += len(decoders)
        self._active_steps += len(live)
        self._prefill_lane_steps += len(prefills)
        self.tick_log.append((len(prefills), len(decoders), time.perf_counter() - t0))
        if health is not None:
            # before the tokens land: a violating slot's token is never kept
            self._sentinel_scan(health, live)

        for s in prefills:
            st = self._slots[s]
            if st is None:  # evicted this tick
                continue
            st.written += takes[s]
            if st.written == st.prefill_len:
                st.phase = "decoding"  # the first token samples next tick
                if self.prefix is not None:
                    bs = self.pool.block_size
                    self._prefix_insert(s, st.req.prompt_len // bs * bs)
        for s in decoders:
            st = self._slots[s]
            if st is None:  # evicted, failed or fallen back this tick
                continue
            tok = int(toks[s])
            st.generated.append(tok)
            if len(st.generated) == 1:
                st.first_token_step, st.first_token_time = self.step_count, time.time()
            if st.req.stop_token is not None and tok == st.req.stop_token:
                self._finish(s, "stop")
            elif len(st.generated) >= st.req.max_new_tokens:
                self._finish(s, "length")
        self.step_count += 1
        return True

    def _paged_tables(self, live: list[int], takes: dict, kind: str) -> int:
        """Grow the live chains over this tick's writes and upload the
        tables the tick reads: the smallest bucket of table columns that
        covers the live block horizon (reads scale with live context, and a
        tick has one shape per (step kind, bucket)).  Returns the bucket."""
        for s in live:
            self.pool.ensure(s, int(self.pool.positions[s]) + takes.get(s, 1))
            if self.prefix is not None:
                # the block this tick's first write lands in is the slot's own
                self.pool.write_barrier(s, int(self.pool.positions[s]))
        horizon = self.pool.active_horizon_blocks()
        bucket = next(b for b in self.horizon_bucket_grid if b >= horizon)
        self._buckets_seen[kind].add(bucket)
        self.horizon_log.append((horizon, bucket))
        self._attended_tokens += bucket * self.pool.block_size
        if self.pool.tables_dirty:
            self._tables_fresh.clear()
            self.pool.tables_dirty = False
        if bucket not in self._tables_fresh:
            for d, sh in enumerate(self.shards):
                sh._tables_dev[bucket].copy_(torch.from_numpy(self.pool.local_tables(d, bucket)))
            self._tables_fresh.add(bucket)
        return bucket

    def _assemble(self, outs: list[np.ndarray]) -> tuple:
        """The shards' tick outputs as the whole pool's: the tokens (N,) and,
        with sentinels, the health {"layers": (L, N, 3), "head": (N,)} f32."""
        n = self.pool.per_device_slots
        toks = np.concatenate([o[:n] for o in outs])
        if not self.sentinels:
            return toks, None
        split = self.model.cfg.n_layers * n * 3
        words = [o[n:].view(np.float32) for o in outs]
        return toks, {"layers": np.concatenate([w[:split].reshape(-1, n, 3) for w in words],
                                               axis=1),
                      "head": np.concatenate([w[split:] for w in words])}

    def run(self, requests: Sequence[Request]) -> list[Completion]:
        """Serve a workload to completion; returns completions in finish order."""
        for req in requests:
            self.submit(req)
        # 2x per-request work: an evicted request pays (part of) its prefill
        # again on resume
        budget = 10_000 + 2 * sum(r.arrival_step + r.max_new_tokens
                                  + -(-r.prompt_len // self.chunk) for r in requests)
        while self.step():
            if self.step_count > budget:
                raise RuntimeError("ContinuousEngine failed to drain workload")
        return self.completions

    # ------------------------------------------------------------ snapshots --
    # The reference's format (``repro/serve/engine.py`` snapshot/restore over
    # ``checkpoint/store.py``): a snapshot of either package restores in the
    # other.  Only between ticks: step() boundaries are the consistent points.

    def _topology(self) -> dict:
        t = {"family": self.model.cfg.family, "norm_impl": self.model.cfg.norm_impl,
             "num_slots": self.num_slots, "max_seq": self.max_seq, "chunk": self.chunk,
             "paged": self.paged, "kv_dtype": self.kv_dtype, "num_devices": self.num_devices,
             "sched": self.sched_policy, "preempt": self.preempt_mode, "seed": self.cfg.seed,
             "sentinels": self.sentinels}
        if self.paged:
            t["block_size"] = self.pool.block_size
            t["num_blocks"] = self.pool.num_blocks
        return t

    @staticmethod
    def _req_arrays(req: Request, tree: dict, prefix: str) -> dict:
        tree[f"{prefix}/tokens"] = np.asarray(req.tokens, np.int32)
        if req.padded_tokens is not None:
            tree[f"{prefix}/padded"] = np.asarray(req.padded_tokens, np.int32)
        for k, v in req.extras.items():
            tree[f"{prefix}/extras/{k}"] = np.asarray(v)
        return {"max_new_tokens": req.max_new_tokens, "temperature": req.temperature,
                "stop_token": req.stop_token, "arrival_step": req.arrival_step,
                "prefix_hint": req.prefix_hint, "req_class": req.req_class,
                "has_padded": req.padded_tokens is not None,
                "extras_keys": sorted(req.extras)}

    def _shard_leaves(self, d: int) -> dict:
        """Shard ``d``'s pool leaves, flat (KV, then the extras), its arenas'
        write-sink block left out."""
        if not self.paged:
            return dict(self.pool.caches[d])
        nb = self.pool.blocks_per_device
        return {**{k: v[:, :nb] for k, v in self.pool.caches[d].items()},
                **self.pool.extras_shards[d]}

    def _leaf_axis(self, name: str) -> int:
        """The axis the shards split a leaf along: an extra leaf's slot axis,
        else 1 (the arenas' block axis, the slabs' slot axis)."""
        return self.model.extra_leaves.get(name, 1)

    def _cache_leaves(self) -> dict:
        """The whole pool's device leaves, flat: the one shard's own tensors
        at ``devices=1``, else CPU copies of the shards' leaves joined along
        their block or slot axis (the reference's global leaves)."""
        if self.num_devices == 1:
            return self._shard_leaves(0)
        shards = [self._shard_leaves(d) for d in range(self.num_devices)]
        return {k: torch.cat([sh[k].cpu() for sh in shards], dim=self._leaf_axis(k))
                for k in shards[0]}

    def _cache_tree(self) -> dict:
        """The pool's device leaves under the reference's names (its cache
        tree: ``layers``, and ``cross`` or ``patches``)."""
        return _cache_tree_of(self._cache_leaves())

    def snapshot(self, path) -> str:
        """Write a crash-consistent snapshot under ``path`` (atomic: a kill
        mid-save never tears an existing one) and return its directory:
        everything the next tick reads.  Refused with an attached prefix
        cache (the radix index is not serialized)."""
        if self.prefix is not None:
            raise ValueError("snapshot with an attached prefix cache is not supported")
        seed = int(self.cfg.seed)
        tree: dict = {
            "cache": self._cache_tree(), "last_logits": self.held_logits(),
            # the reference's initial PRNG key for the seed (the port's
            # sampler is keyed by counters and reads no key)
            "key": np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
            "temps": np.asarray(self._temps), "positions": np.asarray(self.pool.positions),
            "clip_streak": np.asarray(self._clip_streak),
            "device_admits": np.asarray(self._device_admits)}
        requests: dict[int, Request] = {}
        slots_meta = {}
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            requests[st.req.id] = st.req
            if st.padded is not None:
                tree[f"slot/{s}/padded"] = np.asarray(st.padded, np.int32)
            slots_meta[str(s)] = {
                "rid": st.req.id, "admit_step": st.admit_step, "admit_time": st.admit_time,
                "generated": [int(t) for t in st.generated], "phase": st.phase,
                "written": st.written, "prefill_len": st.prefill_len,
                "first_token_step": st.first_token_step,
                "first_token_time": st.first_token_time, "preemptions": st.preemptions,
                "has_padded": st.padded is not None}
        sch = self.scheduler
        if self.sched_policy == "priority":
            sched_meta = {"queues": {c: [r.id for r in q] for c, q in sch._queues.items()},
                          "resumed": sorted(sch._resumed), "shed_count": sch.shed_count}
            queued = [r for q in sch._queues.values() for r in q]
        else:
            sched_meta = {"queue": [r.id for r in sch._queue]}
            queued = list(sch._queue)
        for r in queued:
            requests[r.id] = r
        sched_meta.update(next_id=sch._next_id, pad_tokens=sch._pad_tokens)
        req_meta = {str(rid): self._req_arrays(r, tree, f"req/{rid}")
                    for rid, r in requests.items()}
        sus_meta = {}
        for rid, sus in self._suspended.items():
            spill_meta = None
            if sus.spill is not None:
                sp = sus.spill
                spill_meta = {"position": sp["position"], "written": sp["written"],
                              "prefill_len": sp["prefill_len"], "phase": sp["phase"],
                              "has_padded": sp["padded"] is not None}
                tree[f"sus/{rid}/last_logits"] = sp["last_logits"]
                if sp["padded"] is not None:
                    tree[f"sus/{rid}/padded"] = np.asarray(sp["padded"], np.int32)
                if self.paged:
                    spill_meta["len"] = sp["kv"]["len"]
                    if sp["kv"]["layers"] is not None:
                        tree[f"sus/{rid}/kv"] = sp["kv"]["layers"]
                else:
                    tree[f"sus/{rid}/kv"] = _cache_tree_of(sp["kv"])
            sus_meta[str(rid)] = {
                "generated": [int(t) for t in sus.generated], "admit_step": sus.admit_step,
                "admit_time": sus.admit_time, "first_token_step": sus.first_token_step,
                "first_token_time": sus.first_token_time, "preemptions": sus.preemptions,
                "spill": spill_meta}
        comp_meta = []
        for i, c in enumerate(self.completions):
            tree[f"comp/{i}/prompt"] = np.asarray(c.prompt_tokens, np.int32)
            tree[f"comp/{i}/new"] = np.asarray(c.new_tokens, np.int32)
            comp_meta.append({k: getattr(c, k) for k in _COMPLETION_FIELDS})
        pool = self.pool
        if self.paged:
            pool_meta = {
                "free_slots": list(pool._free_slots), "used": sorted(pool._slot_blocks),
                "slot_blocks": {str(s): list(ch) for s, ch in pool._slot_blocks.items()},
                "free_blocks": [list(q) for q in pool._free_blocks],
                "quarantined": sorted(pool.quarantined), "doomed": sorted(pool._doomed),
                "lost_devices": sorted(pool._lost_devices),
                "peak_blocks_in_use": pool.peak_blocks_in_use,
                "peak_blocks_reserved": pool.peak_blocks_reserved,
                "peak_reserved_per_device": [int(x) for x in pool.peak_reserved_per_device],
                "peak_used_per_device": [int(x) for x in pool.peak_used_per_device]}
            tree.update(tables=pool.tables, refcounts=pool.refcounts, reserved=pool._reserved,
                        shared=pool._shared, owned=pool._owned)
        else:
            pool_meta = {"free": list(pool._free), "used": sorted(pool._used)}
        extra = {
            "topology": self._topology(), "step_count": self.step_count,
            "counters": {
                "active_steps": self._active_steps, "decode_steps": self.model_ticks,
                "fused_ticks": self.fused_ticks, "prefill_lane_steps": self._prefill_lane_steps,
                "generated": self.generated_tokens, "guarded_ticks": self._replayed_ticks,
                "attended_tokens": self._attended_tokens, "preemptions": self._preemptions,
                "resumes": self._resumes, "rejections": self._rejections,
                "sentinel_checks": self._sentinel_checks,
                "sentinel_violations": self._sentinel_violations, "retries": self._retries,
                "fallbacks": self._fallbacks, "table_repairs": self._table_repairs},
            "phase_log": [list(x) for x in self.phase_log],
            "horizon_log": [list(x) for x in self.horizon_log],
            "buckets_seen": {k: sorted(v) for k, v in self._buckets_seen.items()},
            "event_log": [list(e) for e in self.event_log],
            "fault_retries": {str(k): v for k, v in self._fault_retries.items()},
            "slots": slots_meta, "requests": req_meta, "scheduler": sched_meta,
            "suspended": sus_meta, "completions": comp_meta, "pool": pool_meta,
            # the port's own (the reference reads only its keys): tick times
            # and the sentinels' peak residuals
            "tick_log": [list(x) for x in self.tick_log], "sentinel_peaks": self._peak}
        return str(ckpt_store.save(path, self.step_count, tree, extra=_plain(extra)))

    @staticmethod
    def _nest(flat: dict, prefix: str) -> dict:
        """The nested dict of the flat ``prefix...`` keys (digit components
        become int keys, as the reference's)."""
        out: dict = {}
        for name, arr in flat.items():
            if not name.startswith(prefix):
                continue
            parts = [int(p) if p.isdigit() else p for p in name[len(prefix):].split("/")]
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = arr
        return out

    @staticmethod
    def _restore_request(flat: dict, rid: int, meta: dict) -> Request:
        return Request(
            tokens=flat[f"req/{rid}/tokens"].numpy(),
            max_new_tokens=meta["max_new_tokens"], temperature=meta["temperature"],
            stop_token=meta["stop_token"], arrival_step=meta["arrival_step"], id=rid,
            extras={k: flat[f"req/{rid}/extras/{k}"].numpy() for k in meta["extras_keys"]},
            padded_tokens=(flat[f"req/{rid}/padded"].numpy()
                           if meta["has_padded"] else None),
            prefix_hint=meta["prefix_hint"], req_class=meta["req_class"])

    def restore(self, path, step: Optional[int] = None) -> None:
        """Restore a ``snapshot`` (of either package; the latest under
        ``path`` by default) into this engine, built with the same model,
        weights and topology; it then continues as the run that wrote it.
        Every device leaf is copied in place: captured graphs replay on."""
        if step is None:
            step = ckpt_store.latest_step(path)
            if step is None:
                raise FileNotFoundError(f"no snapshot under {path}")
        flat, manifest = ckpt_store.restore_flat(path, step)  # CPU tensors
        extra = manifest["extra"]
        have = self._topology()
        diff = {k: (v, have.get(k)) for k, v in extra["topology"].items() if have.get(k) != v}
        if diff:
            raise ValueError(f"snapshot topology mismatch: {diff}")
        self.reset()
        # --- device state, in place ----------------------------------------
        for d, sh in enumerate(self.shards):
            for name, leaf in self._shard_leaves(d).items():
                ax = self._leaf_axis(name)
                size = leaf.shape[ax]
                leaf.copy_(flat[f"cache/{_leaf_path(name)}"].narrow(ax, d * size, size))
            sh._last_logits.copy_(flat["last_logits"][sh.lo:sh.lo + sh.n])
        self._temps = np.array(flat["temps"].numpy(), np.float32)
        self.pool.positions[:] = flat["positions"].numpy()
        self._clip_streak = np.array(flat["clip_streak"].numpy(), np.int32)
        self._device_admits = np.array(flat["device_admits"].numpy(), np.int64)
        self._lanes_dirty = True  # step() refreshes the device mirrors
        # --- pool ledger ----------------------------------------------------
        p, pool = extra["pool"], self.pool
        if self.paged:
            pool.tables[:] = flat["tables"].numpy()
            pool.tables_dirty = True
            pool.refcounts = np.array(flat["refcounts"].numpy(), np.int32)
            pool._reserved = np.array(flat["reserved"].numpy(), np.int32)
            pool._shared = np.array(flat["shared"].numpy(), np.int32)
            pool._owned = np.array(flat["owned"].numpy(), np.int32)
            pool._free_slots = collections.deque(p["free_slots"])
            pool._slot_blocks = {int(s): list(ch) for s, ch in p["slot_blocks"].items()}
            pool._free_blocks = [collections.deque(q) for q in p["free_blocks"]]
            pool.quarantined, pool._doomed = set(p["quarantined"]), set(p["doomed"])
            pool._lost_devices = set(p["lost_devices"])
            pool.peak_blocks_in_use = p["peak_blocks_in_use"]
            pool.peak_blocks_reserved = p["peak_blocks_reserved"]
            pool.peak_reserved_per_device = np.array(p["peak_reserved_per_device"], np.int64)
            pool.peak_used_per_device = np.array(p["peak_used_per_device"], np.int64)
            pool.check_ledger()
        else:
            pool._free, pool._used = collections.deque(p["free"]), set(p["used"])
        # --- requests, scheduler, slots, suspended --------------------------
        reqs = {int(rid): self._restore_request(flat, int(rid), m)
                for rid, m in extra["requests"].items()}
        sm, sch = extra["scheduler"], self.scheduler
        sch._next_id, sch._pad_tokens = sm["next_id"], sm["pad_tokens"]
        if self.sched_policy == "priority":
            for c, ids in sm["queues"].items():
                sch._queues[c] = collections.deque(reqs[rid] for rid in ids)
            sch._resumed, sch.shed_count = set(sm["resumed"]), sm["shed_count"]
        else:
            sch._queue = collections.deque(reqs[rid] for rid in sm["queue"])
        for s_str, m in extra["slots"].items():
            s = int(s_str)
            self._slots[s] = _SlotState(
                req=reqs[m["rid"]], admit_step=m["admit_step"], admit_time=m["admit_time"],
                generated=list(m["generated"]), phase=m["phase"],
                padded=(flat[f"slot/{s}/padded"].numpy() if m["has_padded"]
                        else None),
                written=m["written"], prefill_len=m["prefill_len"],
                first_token_step=m["first_token_step"],
                first_token_time=m["first_token_time"], preemptions=m["preemptions"])
            self._rids[s] = m["rid"]  # the sampler's stream of the slot
        for rid_str, m in extra["suspended"].items():
            rid, spill = int(rid_str), None
            if m["spill"] is not None:
                sp = m["spill"]
                if self.paged:
                    kv = {"len": sp["len"], "layers": self._nest(flat, f"sus/{rid}/kv/") or None}
                else:
                    kv = {name: flat[f"sus/{rid}/kv/{_leaf_path(name)}"]
                          for name in self.pool.caches[0]}
                spill = {"kv": kv, "position": sp["position"],
                         "padded": (flat[f"sus/{rid}/padded"].numpy()
                                    if sp["has_padded"] else None),
                         "written": sp["written"], "prefill_len": sp["prefill_len"],
                         "phase": sp["phase"],
                         "last_logits": flat[f"sus/{rid}/last_logits"]}
            self._suspended[rid] = _Suspended(
                generated=list(m["generated"]), admit_step=m["admit_step"],
                admit_time=m["admit_time"], first_token_step=m["first_token_step"],
                first_token_time=m["first_token_time"], preemptions=m["preemptions"],
                spill=spill)
        # --- completions, logs, counters ------------------------------------
        for i, m in enumerate(extra["completions"]):
            self.completions.append(Completion(
                prompt_tokens=flat[f"comp/{i}/prompt"].numpy(),
                new_tokens=flat[f"comp/{i}/new"].numpy(),
                **{k: m[k] for k in _COMPLETION_FIELDS}))
        self.event_log = [_detuple(e) for e in extra["event_log"]]
        self.phase_log = [tuple(x) for x in extra["phase_log"]]
        self.horizon_log = [tuple(x) for x in extra["horizon_log"]]
        self.tick_log = [tuple(x) for x in extra.get(
            "tick_log", [(pf, dc, 0.0) for pf, dc in self.phase_log])]
        self._peak = dict(extra.get("sentinel_peaks", self._peak))
        self._buckets_seen = {k: set(v) for k, v in extra["buckets_seen"].items()}
        self._fault_retries = {int(k): v for k, v in extra["fault_retries"].items()}
        c = extra["counters"]
        self.step_count = extra["step_count"]
        (self._active_steps, self.model_ticks, self.fused_ticks, self._prefill_lane_steps,
         self.generated_tokens, self._replayed_ticks, self._attended_tokens,
         self._preemptions, self._resumes, self._rejections, self._sentinel_checks,
         self._sentinel_violations, self._retries, self._fallbacks, self._table_repairs) = (
            c[k] for k in ("active_steps", "decode_steps", "fused_ticks",
                           "prefill_lane_steps", "generated", "guarded_ticks",
                           "attended_tokens", "preemptions", "resumes", "rejections",
                           "sentinel_checks", "sentinel_violations", "retries", "fallbacks",
                           "table_repairs"))

    def device_occupancy(self) -> list[int]:
        """Live slots a device range right now: what least-loaded placement
        balances."""
        n = self.pool.per_device_slots
        return [sum(st is not None for st in self._slots[d * n:(d + 1) * n])
                for d in range(self.num_devices)]

    @property
    def shard_balance(self) -> float:
        """Admission balance over the device ranges: min / max of the
        admissions a device (1.0 even, and on one device)."""
        if self.num_devices == 1 or self._device_admits.max() == 0:
            return 1.0
        return float(self._device_admits.min() / self._device_admits.max())

    def metrics(self) -> dict:
        """The reference's telemetry keys with its meanings (computed on the
        host, outside the captured tick), and the port's own: ``ticks``,
        ``model_ticks``, ``completed`` (= ``completions``), the peak
        residuals, ``capture_seconds`` and ``graph_captures`` (a shard's
        captures, every shard's).  ``kv_hbm_bytes`` counts the
        port's resident pool, its write-sink blocks included."""
        graphs = self.shards[0]._graphs
        out = {
            "ticks": self.step_count,
            "model_ticks": self.model_ticks,
            "fused_ticks": self.fused_ticks,
            "generated_tokens": self.generated_tokens,
            "completions": len(self.completions),
            "completed": len(self.completions),
            "mean_slot_utilization": self._active_steps / max(1, self.model_ticks
                                                               * self.num_slots),
            "prefill_lane_fraction": self._prefill_lane_steps / max(1, self._active_steps),
            "chunk": self.chunk,
            "intake_padding": self.scheduler.intake_padding,
            "kv_hbm_bytes": self.pool.hbm_bytes(),
            "kv_dtype": self.kv_dtype,
            "kv_paged": self.paged,
            "read_path": self.read_path,
            # GN sentinels (the reference's counters): checks count (slot,
            # tick) health evaluations; violations count flagged slots and
            # table repairs; retries and fallbacks the recoveries taken
            "sentinels": self.sentinels,
            "sentinel_checks": self._sentinel_checks,
            "sentinel_violations": self._sentinel_violations,
            "quarantined_blocks": len(self.pool.quarantined) if self.paged else 0,
            "retries": self._retries,
            "fallbacks": self._fallbacks,
            "table_repairs": self._table_repairs,
            "failed_completions": sum(c.finish_reason == "failed" for c in self.completions),
            # the SLA control plane: its policy and its counters
            "sched": self.sched_policy,
            "preempt_mode": self.preempt_mode,
            "preemptions": self._preemptions,
            "preempt_resumes": self._resumes,
            "rejections": self._rejections,
            "shed_count": getattr(self.scheduler, "shed_count", 0),
            # the largest finite residuals checked (not reference keys): the
            # Σp residual is 0 on the kernel read, whose probe is finiteness
            "sentinel_peak_sum_residual": self._peak["sum"],
            "sentinel_peak_sigma_residual": self._peak["sigma"],
            # graph captures, the counterpart of the reference's compilation
            # counters: one per (step kind, bucket) run on the card (slab:
            # per step kind), kept across reset; 0 on the CPU, where no graph
            # exists.  No tick depends on the prompt length, so no prefill is
            # ever captured.  Sharded, every shard captures each key once: the
            # counts are a shard's (``graph_captures`` has every shard's)
            "fused_step_compilations": graphs.captures.get("fused", 0) if graphs else 0,
            "decode_compilations": graphs.captures.get("decode", 0) if graphs else 0,
            "prefill_compilations": 0,
            "capture_seconds": sum(sh._graphs.capture_seconds for sh in self.shards
                                   if sh._graphs is not None),
            "graph_captures": [sum(sh._graphs.captures.values()) if sh._graphs else 0
                               for sh in self.shards],
            # the reference counts ticks dispatched under a guard that refuses
            # implicit host->device transfers; a graph replay moves no host
            # data into the tick (its inputs are staged before), so the port
            # counts its replayed ticks, against decode_steps = model ticks
            "decode_steps": self.model_ticks,
            "transfer_guarded_ticks": self._replayed_ticks,
            # slot-pool sharding (devices=1: one range, balance 1.0)
            "num_devices": self.num_devices,
            "per_device_slots": self.pool.per_device_slots,
            "shard_balance": self.shard_balance,
            "device_admits": [int(n) for n in self._device_admits],
        }
        if self.paged:
            out.update(self._paged_metrics())
        return out

    def _paged_metrics(self) -> dict:
        """The reference's keys of a paged engine: the arena's occupancy, the
        horizon buckets, and with a prefix cache its ``prefix_*`` keys (the
        hit rate token-weighted: cached prompt tokens over admitted ones)."""
        pool, seen = self.pool, self._buckets_seen
        out = {"peak_blocks_in_use": pool.peak_blocks_in_use,
               "peak_blocks_reserved": pool.peak_blocks_reserved,
               "mean_attended_tokens_per_tick": self._attended_tokens / max(1, self.model_ticks),
               "num_blocks": pool.num_blocks, "block_size": pool.block_size,
               "block_utilization": pool.peak_blocks_in_use / max(1, pool.num_blocks),
               "horizon_bucket_grid": list(self.horizon_bucket_grid),
               "horizon_buckets": sorted(seen["fused"] | seen["decode"]),
               "fused_buckets": sorted(seen["fused"]), "decode_buckets": sorted(seen["decode"]),
               "prefix_cache": self.prefix is not None}
        if self.prefix is None:
            return out
        return {**out, "prefix_hit_rate": self._prefix_hit_tokens / max(1, self._prefix_prompt_tokens),
                "prefix_hit_tokens": self._prefix_hit_tokens,
                "prefix_prompt_tokens": self._prefix_prompt_tokens,
                "prefix_hit_requests": self._prefix_hit_requests,
                "prefix_forks": self.pool.prefix_forks,
                "prefix_evictions": self.pool.prefix_evictions,
                "prefix_cached_blocks": self.pool.cached_blocks,
                "prefix_inserts": self.prefix.inserts}

