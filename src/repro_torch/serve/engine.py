"""Serving engines (port of ``repro/serve/engine.py``): the static path
(``generate``, ``perplexity``, ``static_reference``) and the
continuous-batching engine with chunked prefill fused into the tick
(``ContinuousEngine``: FCFS, block-paged fp or int8 KV, one device, GN
runtime sentinels on by default).

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
(B, max_seq) the same way, its position a device scalar.

The tick reads paged KV through ``model.paged_read_path``: the GN paged
attention kernel, or the reference's streamed or gathered read when
``models.attention.FORCE_PAGED_READ`` forces one.  The engine fixes the path
at construction, reports it as ``metrics()["read_path"]`` and refuses to tick
after it changed, so no graph is replayed under another read.

GN runtime sentinels (``sentinels=None`` = on, as the reference's): the
captured tick also computes a health word per live slot, the Σp residual of
every layer's read (+inf on nonfinite values; output finiteness alone on the
kernel read), the int8 clip share, the scale sanity of the live horizon and
the final norm's σ residual, and it comes back in the tick's one
device->host copy beside the tokens.  The host checks it against the GN
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

Not ported, and refused with an error rather than ignored: the prefix
cache, priority scheduling and preemption, snapshots, multi-device pools
(and so device-loss aggregation), and the continuous engine's slab pool.
``kv_dtype="int8"`` serves over int8 arenas with per-block f32 scales frozen
at each block's first write.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import tracekeys
from repro_torch.models.attention import SCALE_SANITY_MAX
from repro_torch.models.transformer import Model
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.sampling import sample
from repro_torch.serve.scheduler import Completion, FCFSScheduler, Request, pad_to_grid

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
        # the replay then writes again
        return self.graphs.run(("decode",), self._step, self._step)


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
    logits, _ = model.prefill(params, {"tokens": tokens}, max_seq, cache=decode.cache)
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
    ``jax.nn.log_softmax``."""
    tokens = _tokens_on(params, batch["tokens"])
    logits = model.forward(params, {"tokens": tokens})[:, :-1].float()
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


@dataclasses.dataclass
class _Suspended:
    """A fault-evicted request's state until admission takes it back; it
    resumes by re-prefilling prompt + ``generated``."""
    generated: list
    admit_step: int
    admit_time: float
    first_token_step: int
    first_token_time: float


def _refuse(name: str, value, default) -> None:
    if value != default:
        raise NotImplementedError(
            f"ContinuousEngine({name}={value!r}) is not ported yet (only {default!r})")


class ContinuousEngine:
    def __init__(self, model: Model, params, num_slots: int, max_seq: int,
                 cfg: ServeConfig = ServeConfig(), chunk: int = 8, block_size: int = 0, num_blocks: int = 0,
                 devices: int = 1, paged: Optional[bool] = None,
                 prefix_cache: bool = False, sched: str = "fcfs", preempt: str = "off",
                 kv_dtype: str = "fp", sentinels: Optional[bool] = None,
                 fault_retry_budget: int = 3, clip_fallback_frac: float = 0.5,
                 clip_patience: int = 3, device_loss_min_slots: int = 2, device=None):
        for name, value, default in (("devices", devices, 1), ("prefix_cache", prefix_cache, False),
                                     ("sched", sched, "fcfs"), ("preempt", preempt, "off")):
            _refuse(name, value, default)
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype must be 'fp' or 'int8', got {kv_dtype!r}")
        if paged is False:
            raise NotImplementedError("the slab pool is not ported; the port pages KV")
        self.model, self.cfg = model, cfg
        self.num_slots, self.max_seq = int(num_slots), int(max_seq)
        self.chunk = int(chunk)
        if not 1 <= self.chunk <= self.max_seq:
            raise ValueError(f"chunk {chunk} must be in [1, {self.max_seq}]")
        self.device = resolve_device(device)
        # GN runtime sentinels, on unless asked off (the reference's default
        # on a paged engine); the retry budget, the int8 clip watchdog, and
        # the reference's device-loss floor (no device loss on one device)
        self.sentinels = True if sentinels is None else bool(sentinels)
        self.fault_retry_budget = int(fault_retry_budget)
        self.clip_fallback_frac = float(clip_fallback_frac)
        self.clip_patience = int(clip_patience)
        self.device_loss_min_slots = int(device_loss_min_slots)
        # the paged read every tick takes, fixed here: a graph captured under
        # one read is never replayed under another (``step`` refuses a change)
        self.read_path = model.paged_read_path
        self.params = model.prepare(params, self.device)
        self.pool = BlockPagedKVPool(model, num_slots, max_seq, block_size or self.chunk,
                                     num_blocks, self.device, kv_dtype)
        # the horizon-bucket grid, as the reference's: each tick reads the
        # smallest power-of-two bucket of block-table columns that covers the
        # live block horizon, so a tick has one shape per (step kind, bucket)
        self.horizon_bucket_grid = tracekeys.horizon_bucket_grid(self.max_seq,
                                                                 self.pool.block_size)
        # the tick's device state: allocated once and updated in place, so a
        # graph captured from one tick reads and writes the same tensors on
        # every replay.  Per step kind: chunk tokens, n_valid, is_prefill;
        # per bucket: a contiguous (N, bucket) block table.
        dev, n = self.device, self.num_slots
        self._last_logits = torch.zeros(n, model.cfg.vocab, dtype=torch.float32, device=dev)
        self._pos_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        self._temps_dev = torch.zeros(n, dtype=torch.float32, device=dev)
        self._rids_dev = torch.zeros(n, dtype=torch.int64, device=dev)  # the sampler's streams
        self._parked = torch.zeros(n, dtype=torch.bool, device=dev)  # the warm-up's mask
        self._inputs = {kind: (torch.zeros(n, c, dtype=torch.int32, device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev),
                               torch.zeros(n, dtype=torch.bool, device=dev))
                        for kind, c in (("fused", self.chunk), ("decode", 1))}
        self._tables_dev = {b: torch.zeros(n, b, dtype=torch.int32, device=dev)
                            for b in self.horizon_bucket_grid}
        # on the card every tick is a graph replay (captured once per key and
        # kept across reset, as the reference keeps its compiled ticks); on
        # the CPU the same tick runs eagerly
        self._graphs = StepGraphs(dev) if dev.type == "cuda" else None
        self.reset()

    def reset(self) -> None:
        """Clear all serving state but keep the weights and the pool's arenas;
        slot and block order are restored, so a reset run replays a workload
        with identical slot assignment, block tables and sampled tokens."""
        self.pool.reset()
        n = self.num_slots
        for t in (self._last_logits, self._pos_dev, self._active_dev, self._temps_dev,
                  self._rids_dev):
            t.zero_()
        self._temps = np.zeros(n, np.float32)  # host mirrors of the sampler's state
        self._rids = np.zeros(n, np.int64)
        self._tables_fresh: set[int] = set()  # buckets whose buffer holds the host tables
        self._lanes_dirty = True
        self._slots: list[Optional[_SlotState]] = [None] * n
        self.scheduler = FCFSScheduler(chunk_grid=self.chunk)
        self.step_count = 0
        self.completions: list[Completion] = []
        self.model_ticks = 0      # ticks that ran the model
        self._replayed_ticks = 0  # ... of which as a graph replay
        self.fused_ticks = 0      # ... of which carried a prefill lane
        self.generated_tokens = 0
        # (prefill lanes, decode lanes, host seconds) per model tick
        self.tick_log: list[tuple[int, int, float]] = []
        # the horizon buckets each step kind ran at since the reset
        self._buckets_seen: dict[str, set] = {"fused": set(), "decode": set()}
        # the deterministic event trace (admit, resume, finish, and every
        # sentinel verdict, each with its step), as the reference's
        self.event_log: list[tuple] = []
        self._suspended: dict[int, _Suspended] = {}
        self._resumes = 0
        self._sentinel_checks = 0
        self._sentinel_violations = 0
        self._retries = 0
        self._fallbacks = 0
        self._table_repairs = 0
        self._fault_retries: dict[int, int] = {}
        self._clip_streak = np.zeros(n, np.int32)
        # the largest finite Σp and σ residuals checked: the margin to the bounds
        self._peak = {"sum": 0.0, "sigma": 0.0}

    def submit(self, req: Request) -> int:
        return self.scheduler.submit(req)

    # ------------------------------------------------------------ admission --
    def _admit(self) -> None:
        while True:
            head = self.scheduler.peek_ready(self.step_count)
            if head is None:
                break
            footprint = head.prompt_len + head.max_new_tokens
            if footprint > self.max_seq:
                raise ValueError(f"request {head.id}: prompt {head.prompt_len} + "
                                 f"{head.max_new_tokens} new tokens exceeds max_seq {self.max_seq}")
            if self.pool.blocks_for(footprint) > self.pool.num_blocks:
                raise ValueError(f"request {head.id}: footprint {footprint} tokens needs "
                                 f"{self.pool.blocks_for(footprint)} blocks, the arena has "
                                 f"{self.pool.num_blocks} — unservable at any occupancy")
            # FCFS: the head waits for a free slot AND its whole reservation
            if not self.pool.num_free or not self.pool.can_reserve(footprint):
                break
            req = self.scheduler.pop_ready(self.step_count)
            sus = self._suspended.pop(req.id, None)
            slot = self.pool.allocate(reserve_tokens=footprint)
            if sus is None:
                padded, prefill_len = req.padded_tokens, req.prompt_len
            else:
                # recompute resume: prefill prompt + generated anew; chunked
                # prefill is token-identical to the decode that made them, so
                # the held logits end where the uninterrupted run's were
                seq = np.concatenate([np.asarray(req.tokens, np.int32),
                                      np.asarray(sus.generated, np.int32)])
                padded, prefill_len = pad_to_grid(seq, self.chunk), int(seq.shape[0])
            temp = self.cfg.temperature if req.temperature is None else req.temperature
            self._temps[slot], self._rids[slot] = float(temp), req.id
            self._slots[slot] = _SlotState(
                req=req, admit_step=sus.admit_step if sus else self.step_count,
                admit_time=sus.admit_time if sus else time.time(),
                generated=sus.generated if sus else [], padded=padded, prefill_len=prefill_len,
                first_token_step=sus.first_token_step if sus else -1,
                first_token_time=sus.first_token_time if sus else 0.0)
            self._lanes_dirty = True
            self._clip_streak[slot] = 0
            if sus is not None:
                self._resumes += 1
            self.event_log.append(("resume" if sus else "admit", self.step_count, req.id, slot, 0))

    def _finish(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
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
        spent."""
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
        ix = torch.tensor(chain, dtype=torch.long, device=self.device)
        hit = torch.zeros(len(chain), dtype=torch.bool)
        for name, leaf in self.pool.cache.items():
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
            first_token_step=st.first_token_step, first_token_time=st.first_token_time)
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
            row = generate(self.model, self.params, {"tokens": seq[None]}, gcfg)[0].cpu().numpy()
            gen = list(st.generated)
            for tok in row[seq.shape[0]:]:
                gen.append(int(tok))
                if req.stop_token is not None and int(tok) == req.stop_token:
                    reason = "stop"
                    break
            st.generated = gen
        self._finish(slot, reason)

    # ----------------------------------------------------------------- ticks --
    def _tick(self, active, tokens, n_valid, is_prefill, tables):
        """Sample each decoding slot's token from the held logits into lane 0,
        run the model once, and update the held logits and positions in
        place.  Returns the sampled tokens (N,) int32, followed with
        sentinels by the health word's f32 bits (L * N * 3 + N), still on
        the device: one copy takes both.  With ``active`` all false (the
        warm-up before a capture) every lane is parked: the writes go to the
        sink block, and the held logits and positions keep their values."""
        nxt = sample(self._last_logits, self._temps_dev, self.cfg.seed, self._rids_dev,
                     self._pos_dev)
        dec = torch.where(active & ~is_prefill, nxt, 0).to(torch.int32)
        lane0 = torch.zeros_like(tokens)
        lane0[:, 0] = dec
        tokens = torch.where(is_prefill[:, None], tokens, lane0)
        nv = torch.where(active, torch.where(is_prefill, n_valid, 1), 0).to(torch.int32)
        pos = torch.where(active, self._pos_dev, 0).to(torch.int32)
        out = self.model.fused_step_slots_paged(self.params, self.pool.cache, tokens, pos, nv,
                                                tables, sentinel=self.sentinels)
        logits, health = out if self.sentinels else (out, None)
        self._last_logits.copy_(torch.where(active[:, None], logits[:, 0].float(),
                                            self._last_logits))
        self._pos_dev.add_(nv)
        if health is None:
            return dec
        return torch.cat([dec, health["layers"].flatten().view(torch.int32),
                          health["head"].view(torch.int32)])

    def _run_tick(self, kind: str, bucket: int):
        """The tick of ``kind`` over the ``bucket``-wide tables: eagerly on
        the CPU, a graph replay on the card."""
        args = (*self._inputs[kind], self._tables_dev[bucket])
        if self._graphs is None:
            return self._tick(self._active_dev, *args)
        self._replayed_ticks += 1
        return self._graphs.run((kind, bucket), lambda: self._tick(self._active_dev, *args),
                                lambda: self._tick(self._parked, *args))

    def step(self) -> bool:
        """One engine tick.  Returns False once fully drained."""
        if self.model.paged_read_path != self.read_path:
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
            for buf, host in ((self._active_dev, active), (self._pos_dev, self.pool.positions),
                              (self._temps_dev, self._temps), (self._rids_dev, self._rids)):
                buf.copy_(torch.from_numpy(host))
            self._lanes_dirty = False
        takes = {s: min(self.chunk, self._slots[s].prefill_len - self._slots[s].written)
                 for s in prefills}
        for s in live:
            self.pool.ensure(s, int(self.pool.positions[s]) + takes.get(s, 1))
        # the tick reads the smallest bucket of table columns that covers the
        # live block horizon: reads scale with live context, and a tick has
        # one shape per (step kind, bucket)
        horizon = self.pool.active_horizon_blocks()
        bucket = next(b for b in self.horizon_bucket_grid if b >= horizon)
        kind = "fused" if prefills else "decode"
        self._buckets_seen[kind].add(bucket)
        if self.pool.tables_dirty:
            self._tables_fresh.clear()
            self.pool.tables_dirty = False
        if bucket not in self._tables_fresh:
            self._tables_dev[bucket].copy_(torch.from_numpy(self.pool.tables[:, :bucket]))
            self._tables_fresh.add(bucket)
        if prefills:  # stage the chunk; the decode step's inputs stay zero
            chunk_toks = np.zeros((self.num_slots, self.chunk), np.int32)
            n_valid = np.ones(self.num_slots, np.int32)
            is_pref = np.zeros(self.num_slots, bool)
            for s in prefills:
                st = self._slots[s]
                chunk_toks[s] = st.padded[st.written: st.written + self.chunk]
                n_valid[s] = takes[s]
                is_pref[s] = True
            for buf, host in zip(self._inputs[kind], (chunk_toks, n_valid, is_pref)):
                buf.copy_(torch.from_numpy(host))
            self.fused_ticks += 1
        out = self._run_tick(kind, bucket).cpu().numpy()  # the tick's one device->host copy
        n = self.num_slots
        toks, health = out[:n], None
        if self.sentinels:
            words = out[n:].view(np.float32)
            split = self.model.cfg.n_layers * n * 3
            health = {"layers": words[:split].reshape(-1, n, 3), "head": words[split:]}
        self.pool.advance({s: takes.get(s, 1) for s in live})
        self.model_ticks += 1
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
        for s in decoders:
            st = self._slots[s]
            if st is None:  # evicted, failed or fallen back this tick
                continue
            tok = int(toks[s])
            st.generated.append(tok)
            self.generated_tokens += 1
            if len(st.generated) == 1:
                st.first_token_step, st.first_token_time = self.step_count, time.time()
            if st.req.stop_token is not None and tok == st.req.stop_token:
                self._finish(s, "stop")
            elif len(st.generated) >= st.req.max_new_tokens:
                self._finish(s, "length")
        self.step_count += 1
        return True

    def run(self, requests: Sequence[Request]) -> list[Completion]:
        """Serve a workload to completion; returns completions in finish order."""
        for req in requests:
            self.submit(req)
        # 2x per-request work: a fault-evicted request pays (part of) its
        # prefill again on resume
        budget = 10_000 + 2 * sum(r.arrival_step + r.max_new_tokens
                                  + -(-r.prompt_len // self.chunk) for r in requests)
        while self.step():
            if self.step_count > budget:
                raise RuntimeError("ContinuousEngine failed to drain workload")
        return self.completions

    def metrics(self) -> dict:
        graphs = self._graphs
        return {
            "ticks": self.step_count,
            "model_ticks": self.model_ticks,
            "fused_ticks": self.fused_ticks,
            "generated_tokens": self.generated_tokens,
            "completed": len(self.completions),
            "peak_blocks_in_use": self.pool.peak_blocks_in_use,
            "kv_dtype": self.pool.kv_dtype,
            "num_blocks": self.pool.num_blocks,
            "block_size": self.pool.block_size,
            "block_utilization": self.pool.peak_blocks_in_use / max(1, self.pool.num_blocks),
            "kv_paged": True,
            "read_path": self.read_path,
            # GN sentinels (the reference's counters): checks count (slot,
            # tick) health evaluations; violations count flagged slots and
            # table repairs; retries and fallbacks the recoveries taken
            "sentinels": self.sentinels,
            "sentinel_checks": self._sentinel_checks,
            "sentinel_violations": self._sentinel_violations,
            "quarantined_blocks": len(self.pool.quarantined),
            "retries": self._retries,
            "fallbacks": self._fallbacks,
            "table_repairs": self._table_repairs,
            "failed_completions": sum(c.finish_reason == "failed" for c in self.completions),
            "preempt_resumes": self._resumes,
            # the largest finite residuals checked (not reference keys): the
            # Σp residual is 0 on the kernel read, whose probe is finiteness
            "sentinel_peak_sum_residual": self._peak["sum"],
            "sentinel_peak_sigma_residual": self._peak["sigma"],
            "horizon_bucket_grid": list(self.horizon_bucket_grid),
            "horizon_buckets": sorted(self._buckets_seen["fused"] | self._buckets_seen["decode"]),
            "fused_buckets": sorted(self._buckets_seen["fused"]),
            "decode_buckets": sorted(self._buckets_seen["decode"]),
            # graph captures, the counterpart of the reference's compilation
            # counters: one per (step kind, bucket) run on the card, kept
            # across reset; 0 on the CPU, where no graph exists.  No tick
            # depends on the prompt length, so no prefill is ever captured.
            "fused_step_compilations": graphs.captures.get("fused", 0) if graphs else 0,
            "decode_compilations": graphs.captures.get("decode", 0) if graphs else 0,
            "prefill_compilations": 0,
            "capture_seconds": graphs.capture_seconds if graphs else 0.0,
            # the reference counts ticks dispatched under a guard that refuses
            # implicit host->device transfers; a graph replay moves no host
            # data into the tick (its inputs are staged before), so the port
            # counts its replayed ticks, against decode_steps = model ticks
            "decode_steps": self.model_ticks,
            "transfer_guarded_ticks": self._replayed_ticks,
        }
