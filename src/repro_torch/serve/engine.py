"""Serving engines (port of ``repro/serve/engine.py``): the static path
(``generate``, ``perplexity``, ``static_reference``) and the
continuous-batching engine with chunked prefill fused into the tick
(``ContinuousEngine``: FCFS, greedy, block-paged fp KV, one device).

The static path serves uniform-length prompt batches: one prefill over a
dense slab cache, then one decode step per new token; it is the greedy
oracle the continuous engine is held against.  Its functions take
``model.prepare``d parameters and run on their device.

Admission pages an empty slot in; each tick then runs the model once over
the live slots.  A tick with a prefilling slot is *fused*: every slot gets
a (chunk,)-lane set, decoding slots sample their next token into lane 0
(n_valid = 1) and prefilling slots take the next chunk of their prompt.  A
tick where every live slot decodes takes the (num_slots, 1) decode step.
Parked slots get n_valid = 0: they neither write nor own blocks.

Per-tick host<->device traffic: the next tokens come back in one copy;
positions advance on the device; the active mask, positions and block
tables are uploaded only when admission, completion or block growth made
their host mirrors dirty; a fused tick also uploads its staged chunk.

Not ported, and refused with an error rather than ignored: sampling
(temperature > 0, in both paths), GN sentinels, the prefix cache, priority
scheduling and preemption, int8 KV, snapshots, multi-device pools, and the
continuous engine's slab pool.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.scheduler import Completion, FCFSScheduler, Request


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy; the port serves greedy only
    seed: int = 0             # the sampling key's seed (sampling is not ported)


def _refuse_sampling(temperature) -> None:
    if temperature:
        raise NotImplementedError("sampling (temperature > 0) is not ported; greedy only")


# ---------------------------------------------------------------- static ---
def _tokens_on(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens).to(params["embed"]["tok"].device)


def generate(model: Model, params, batch: dict, cfg: ServeConfig) -> torch.Tensor:
    """batch["tokens"]: (B, S_prompt) -> (B, S_prompt + max_new_tokens) int32
    tokens, greedy.  Prefill once, then ``max_new_tokens`` decode steps; as
    in the reference, the last step's logits are computed and not used."""
    _refuse_sampling(cfg.temperature)
    tokens = _tokens_on(params, batch["tokens"])
    b, s = tokens.shape
    max_seq = s + cfg.max_new_tokens
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq)
    last = logits[:, -1].clone()
    del logits
    out = torch.zeros(b, max_seq, dtype=torch.int32, device=tokens.device)
    out[:, :s] = tokens
    for i in range(cfg.max_new_tokens):
        nxt = last.argmax(dim=-1).to(torch.int32)[:, None]
        out[:, s + i:s + i + 1] = nxt
        logits_step, cache = model.decode_step(params, cache, nxt, s + i)
        last = logits_step[:, 0]
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
    padded: np.ndarray            # prompt padded to the chunk grid
    phase: str = "prefilling"     # 'prefilling' | 'decoding'
    written: int = 0              # prompt tokens committed to the cache
    first_token_step: int = -1
    first_token_time: float = 0.0


def _refuse(name: str, value, default) -> None:
    if value != default:
        raise NotImplementedError(
            f"ContinuousEngine({name}={value!r}) is not ported yet (only {default!r})")


class ContinuousEngine:
    def __init__(self, model: Model, params, num_slots: int, max_seq: int,
                 cfg: ServeConfig = ServeConfig(), chunk: int = 8, block_size: int = 0, num_blocks: int = 0,
                 devices: int = 1, paged: Optional[bool] = None,
                 prefix_cache: bool = False, sched: str = "fcfs", preempt: str = "off",
                 kv_dtype: str = "fp", sentinels: bool = False, device=None):
        for name, value, default in (("devices", devices, 1), ("prefix_cache", prefix_cache, False),
                                     ("sched", sched, "fcfs"), ("preempt", preempt, "off"),
                                     ("kv_dtype", kv_dtype, "fp"), ("sentinels", sentinels, False)):
            _refuse(name, value, default)
        if paged is False:
            raise NotImplementedError("the slab pool is not ported; the port pages KV")
        _refuse_sampling(cfg.temperature)
        self.model, self.cfg = model, cfg
        self.num_slots, self.max_seq = int(num_slots), int(max_seq)
        self.chunk = int(chunk)
        if not 1 <= self.chunk <= self.max_seq:
            raise ValueError(f"chunk {chunk} must be in [1, {self.max_seq}]")
        self.device = resolve_device(device)
        self.params = model.prepare(params, self.device)
        self.pool = BlockPagedKVPool(model, num_slots, max_seq, block_size or self.chunk,
                                     num_blocks, self.device)
        self.reset()

    def reset(self) -> None:
        """Clear all serving state but keep the weights and the pool's arenas;
        slot and block order are restored, so a reset run replays a workload
        with identical slot assignment and block tables."""
        self.pool.reset()
        dev, n = self.device, self.num_slots
        self._last_logits = torch.zeros(n, self.model.cfg.vocab, dtype=torch.float32, device=dev)
        self._pos_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        self._tables_dev = torch.zeros(n, 1, dtype=torch.int32, device=dev)
        self._lanes_dirty = True
        self._slots: list[Optional[_SlotState]] = [None] * n
        self.scheduler = FCFSScheduler(chunk_grid=self.chunk)
        self.step_count = 0
        self.completions: list[Completion] = []
        self.model_ticks = 0      # ticks that ran the model
        self.fused_ticks = 0      # ... of which carried a prefill lane
        self.generated_tokens = 0
        # (prefill lanes, decode lanes, host seconds) per model tick
        self.tick_log: list[tuple[int, int, float]] = []

    def submit(self, req: Request) -> int:
        _refuse_sampling(req.temperature)
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
            slot = self.pool.allocate(reserve_tokens=footprint)
            self._slots[slot] = _SlotState(req=req, admit_step=self.step_count,
                                           admit_time=time.time(), generated=[],
                                           padded=req.padded_tokens)
            self._lanes_dirty = True

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
        self._slots[slot] = None
        self.pool.free(slot)
        self._lanes_dirty = True

    # ----------------------------------------------------------------- ticks --
    def _tick(self, tokens, n_valid, is_prefill):
        """Sample each decoding slot's token from the held logits into lane 0,
        run the model once, and hold the new next-token logits.  Returns the
        sampled tokens (N,), still on the device."""
        active = self._active_dev
        dec = torch.where(active & ~is_prefill, self._last_logits.argmax(dim=-1), 0)
        dec = dec.to(torch.int32)
        lane0 = torch.zeros_like(tokens)
        lane0[:, 0] = dec
        tokens = torch.where(is_prefill[:, None], tokens, lane0)
        nv = torch.where(active, torch.where(is_prefill, n_valid, 1), 0).to(torch.int32)
        pos = torch.where(active, self._pos_dev, 0).to(torch.int32)
        logits = self.model.fused_step_slots_paged(self.params, self.pool.cache, tokens,
                                                   pos, nv, self._tables_dev)
        self._last_logits = torch.where(active[:, None], logits[:, 0].float(),
                                        self._last_logits)
        self._pos_dev = self._pos_dev + nv
        return dec

    def step(self) -> bool:
        """One engine tick.  Returns False once fully drained."""
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
        dev = self.device
        prefills = [s for s in live if self._slots[s].phase == "prefilling"]
        decoders = [s for s in live if self._slots[s].phase == "decoding"]
        if self._lanes_dirty:  # residency changed: refresh the device mirrors
            active = np.array([st is not None for st in self._slots])
            self._active_dev = torch.as_tensor(active).to(dev)
            self._pos_dev = torch.as_tensor(self.pool.positions).to(dev)
            self._lanes_dirty = False
        takes = {s: min(self.chunk, self._slots[s].req.prompt_len - self._slots[s].written)
                 for s in prefills}
        for s in live:
            self.pool.ensure(s, int(self.pool.positions[s]) + takes.get(s, 1))
        # the tables go up sliced to the live block horizon: reads and
        # gathers scale with live context, not max_seq
        horizon = max(self.pool.active_horizon_blocks(), 1)
        if self.pool.tables_dirty or self._tables_dev.shape[1] != horizon:
            self._tables_dev = torch.as_tensor(self.pool.tables[:, :horizon].copy()).to(dev)
            self.pool.tables_dirty = False
        if prefills:
            chunk_toks = np.zeros((self.num_slots, self.chunk), np.int32)
            n_valid = np.ones(self.num_slots, np.int32)
            is_pref = np.zeros(self.num_slots, bool)
            for s in prefills:
                st = self._slots[s]
                chunk_toks[s] = st.padded[st.written: st.written + self.chunk]
                n_valid[s] = takes[s]
                is_pref[s] = True
            dec = self._tick(torch.as_tensor(chunk_toks).to(dev),
                             torch.as_tensor(n_valid).to(dev), torch.as_tensor(is_pref).to(dev))
            self.fused_ticks += 1
        else:  # steady state: every live slot decodes -> the (N, 1) step
            zeros = torch.zeros(self.num_slots, dtype=torch.int32, device=dev)
            dec = self._tick(zeros[:, None], zeros, zeros.bool())
        toks = dec.cpu().numpy()  # the tick's one device->host copy
        self.pool.advance({s: takes.get(s, 1) for s in live})
        self.model_ticks += 1
        self.tick_log.append((len(prefills), len(decoders), time.perf_counter() - t0))

        for s in prefills:
            st = self._slots[s]
            st.written += takes[s]
            if st.written == st.req.prompt_len:
                st.phase = "decoding"  # the first token samples next tick
        for s in decoders:
            st = self._slots[s]
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
        budget = 10_000 + 2 * sum(r.arrival_step + r.max_new_tokens
                                  + -(-r.prompt_len // self.chunk) for r in requests)
        while self.step():
            if self.step_count > budget:
                raise RuntimeError("ContinuousEngine failed to drain workload")
        return self.completions

    def metrics(self) -> dict:
        return {
            "ticks": self.step_count,
            "model_ticks": self.model_ticks,
            "fused_ticks": self.fused_ticks,
            "generated_tokens": self.generated_tokens,
            "completed": len(self.completions),
            "peak_blocks_in_use": self.pool.peak_blocks_in_use,
        }
