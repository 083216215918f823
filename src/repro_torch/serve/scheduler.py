"""Request/Completion API and the admission schedulers (port of
``repro/serve/scheduler.py``): FCFS, and the SLA control plane's
``PriorityScheduler``.

Requests are admitted in submission order within a queue, each as soon as
its arrival step has been reached on the engine clock and the pool can take
it.  The clock is the engine's tick counter, so a seeded workload replays
identically.  Prompts are bucketed to the fused step's chunk grid at submit.

``PriorityScheduler`` adds class-aware admission (interactive over batch)
with an aging bound, and watermark shedding of batch backlog.  Its rank
rule compares arrival steps only (``interactive h outranks batch b iff
h.arrival_step < b.arrival_step + aging_steps``), so the engine reuses it
for preemption victims without an admit/preempt livelock: the order of two
requests never changes as the clock advances.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

# the SLA classes: 'interactive' is latency-sensitive (TTFT-judged),
# 'batch' is throughput traffic (preemptible, sheddable under overload)
REQUEST_CLASSES = ("interactive", "batch")

# the closed set of completion verdicts: 'length' = decode budget spent,
# 'stop' = stop token, 'rejected' = shed before admission, 'failed' = the GN
# sentinels' retry budget spent (the fault record is in the engine's event log)
FINISH_REASONS = ("length", "stop", "rejected", "failed")


def pad_to_grid(tokens, grid: int) -> np.ndarray:
    """Right-pad a prompt to the next multiple of the chunk grid (the pad
    tokens are never computed on: the fused step masks lanes past the true
    remaining length)."""
    t = np.asarray(tokens, np.int32).reshape(-1)
    if grid <= 1:
        return t
    rem = (-t.shape[0]) % grid
    return np.concatenate([t, np.zeros(rem, np.int32)]) if rem else t


@dataclasses.dataclass
class Request:
    """One generation request.  ``tokens`` is the prompt, shape (prompt_len,);
    ``arrival_step`` stamps when it becomes visible on the engine clock.
    ``extras`` carries the request's modality inputs without a batch axis,
    numpy arrays: ``frames`` (encoder_seq, D) for encdec, ``patches``
    (num_patches, D) for the VLM; admission turns them into the slot's extra
    cache leaves.
    ``prefix_hint`` is the indexed prefix length at submit (telemetry only:
    admission looks the prefix up again); ``req_class`` is one of
    REQUEST_CLASSES (FCFS ignores it)."""

    tokens: np.ndarray
    max_new_tokens: int = 16
    temperature: Optional[float] = None  # None -> engine default
    stop_token: Optional[int] = None
    arrival_step: int = 0
    extras: dict = dataclasses.field(default_factory=dict)
    id: int = -1  # assigned by the scheduler on submit
    padded_tokens: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    prefix_hint: int = 0
    req_class: str = "interactive"

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclasses.dataclass
class Completion:
    """A finished request plus its serving telemetry (steps = engine clock)."""

    request_id: int
    prompt_tokens: np.ndarray
    new_tokens: np.ndarray
    finish_reason: str  # one of FINISH_REASONS
    arrival_step: int
    admit_step: int  # -1 when rejected (never admitted)
    first_token_step: int  # -1 when rejected
    finish_step: int
    admit_time: float
    first_token_time: float
    finish_time: float
    req_class: str = "interactive"
    preemptions: int = 0  # times this request was evicted and later resumed

    def __post_init__(self):
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(f"unknown finish_reason {self.finish_reason!r}; "
                             f"expected one of {FINISH_REASONS}")

    @property
    def tokens(self) -> np.ndarray:
        """Full sequence (prompt + generated)."""
        return np.concatenate([self.prompt_tokens, self.new_tokens])

    @property
    def ttft_s(self) -> float:
        return self.first_token_time - self.admit_time

    @property
    def latency_s(self) -> float:
        return self.finish_time - self.admit_time

    # the reference's arrival-anchored fields on the engine's step clock,
    # deterministic under replay (ttft_s starts at admission and hides the
    # queue wait)
    @property
    def queue_wait_steps(self) -> int:
        """Engine steps spent waiting for admission (arrival -> admit; a
        rejected request: arrival -> verdict)."""
        if self.admit_step < 0:
            return self.finish_step - self.arrival_step
        return self.admit_step - self.arrival_step

    @property
    def ttft_steps(self) -> int:
        """Arrival -> first generated token on the step clock; -1 without one."""
        if self.first_token_step < 0:
            return -1
        return self.first_token_step - self.arrival_step

    @property
    def tpot_steps(self) -> float:
        """Mean steps per generated token after the first (1.0 for an
        uninterrupted decode; preemption gaps and re-prefills inflate it);
        0.0 below two tokens."""
        n = int(np.asarray(self.new_tokens).shape[0])
        if n < 2:
            return 0.0
        return (self.finish_step - self.first_token_step) / (n - 1)


class FCFSScheduler:
    """First-come-first-served admission; the head of the queue blocks, so
    admission order (and slot assignment) is deterministic.  With a
    ``prefix_cache`` (the engine passes its own), submit stamps each queued
    request's ``prefix_hint`` through the stamp-free ``match_len``."""

    def __init__(self, chunk_grid: int = 0, prefix_cache=None):
        self.chunk_grid = int(chunk_grid)
        self.prefix_cache = prefix_cache
        self._queue: deque[Request] = deque()
        self._next_id = 0
        self._pad_tokens = 0  # total intake padding (bucketing overhead)

    def submit(self, req: Request) -> int:
        """Enqueue a bucketed *copy* of ``req`` and return its id."""
        queued = self._prepare(req)
        self._enqueue(queued)
        return queued.id

    def _prepare(self, req: Request) -> Request:
        if req.max_new_tokens < 1:
            raise ValueError(f"request needs max_new_tokens >= 1, got {req.max_new_tokens}")
        if req.req_class not in REQUEST_CLASSES:
            raise ValueError(f"unknown req_class {req.req_class!r}; "
                             f"expected one of {REQUEST_CLASSES}")
        rid = req.id if req.id >= 0 else self._next_id
        self._next_id = max(self._next_id, rid) + 1
        queued = dataclasses.replace(req, id=rid)
        queued.padded_tokens = (
            pad_to_grid(queued.tokens, self.chunk_grid) if self.chunk_grid else None
        )
        if self.chunk_grid:
            self._pad_tokens += int(queued.padded_tokens.shape[0]) - queued.prompt_len
        if self.prefix_cache is not None:
            queued.prefix_hint = self.prefix_cache.match_len(queued.tokens)
        return queued

    def _enqueue(self, queued: Request) -> None:
        self._queue.append(queued)

    @property
    def intake_padding(self) -> int:
        """Total pad tokens added by bucketing (<= grid - 1 per request)."""
        return self._pad_tokens

    def requeue_front(self, req: Request) -> None:
        """Put an already submitted request back at the head of its queue
        (an evicted request keeps its id, padding and arrival)."""
        self._queue.appendleft(req)

    def next_ready_step(self) -> Optional[int]:
        """Arrival step of the head (FCFS is head-blocking), or None."""
        return self._queue[0].arrival_step if self._queue else None

    def poll_shed(self, step: int, live_units: int, unit_fn) -> list[Request]:
        """The engine's shedding hook, each admission pass: FCFS never sheds."""
        return []

    def peek_ready(self, step: int) -> Optional[Request]:
        if self._queue and self._queue[0].arrival_step <= step:
            return self._queue[0]
        return None

    def pop_ready(self, step: int) -> Optional[Request]:
        if self._queue and self._queue[0].arrival_step <= step:
            return self._queue.popleft()
        return None

    def has_pending(self) -> bool:
        return bool(self._queue)

    def __len__(self) -> int:
        return len(self._queue)


class PriorityScheduler(FCFSScheduler):
    """Two FCFS queues, one per class.  When both heads have arrived the
    rank rule picks: the interactive head wins unless the batch head has
    aged ``aging_steps`` past it (the starvation bound).

    Shedding (``shed_backlog`` > 0, in the pool's blocks): each admission
    pass the engine reports its live reservation and a per-request
    footprint; arrived batch backlog past the watermark is rejected, head
    first, so the survivors are deterministic.  Interactive requests and
    preempted-then-requeued ones are never shed."""

    def __init__(self, chunk_grid: int = 0, prefix_cache=None, aging_steps: int = 64,
                 shed_backlog: int = 0):
        super().__init__(chunk_grid, prefix_cache)
        if aging_steps < 1:
            raise ValueError(f"aging_steps must be >= 1, got {aging_steps}")
        self.aging_steps = int(aging_steps)
        self.shed_backlog = int(shed_backlog)
        self._queues: dict[str, deque[Request]] = {c: deque() for c in REQUEST_CLASSES}
        self._resumed: set[int] = set()  # ids requeued by preemption
        self.shed_count = 0

    def _enqueue(self, queued: Request) -> None:
        self._queues[queued.req_class].append(queued)

    def requeue_front(self, req: Request) -> None:
        self._resumed.add(req.id)
        self._queues[req.req_class].appendleft(req)

    def outranks(self, interactive_arrival: int, batch_arrival: int) -> bool:
        """The step-independent rank rule."""
        return interactive_arrival < batch_arrival + self.aging_steps

    def _pick_class(self, step: int) -> Optional[str]:
        heads = {c: q[0] for c, q in self._queues.items() if q and q[0].arrival_step <= step}
        if len(heads) == 2:
            i, b = heads["interactive"], heads["batch"]
            return "interactive" if self.outranks(i.arrival_step, b.arrival_step) else "batch"
        return next(iter(heads), None)

    def peek_ready(self, step: int) -> Optional[Request]:
        c = self._pick_class(step)
        return self._queues[c][0] if c else None

    def pop_ready(self, step: int) -> Optional[Request]:
        c = self._pick_class(step)
        if c is None:
            return None
        req = self._queues[c].popleft()
        self._resumed.discard(req.id)
        return req

    def has_pending(self) -> bool:
        return any(self._queues.values())

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def next_ready_step(self) -> Optional[int]:
        # either class head may be admitted: the earlier head arrival
        heads = [q[0].arrival_step for q in self._queues.values() if q]
        return min(heads) if heads else None

    def poll_shed(self, step: int, live_units: int, unit_fn) -> list[Request]:
        """Shed arrived batch backlog past the watermark.  Demand adds up
        head-ordered: live + arrived interactive + arrived batch in queue
        order; a batch request that would take demand past ``shed_backlog``
        is shed.  The scan stops at the first request not yet arrived, so
        the engine's idle fast-forward skips no shedding."""
        if self.shed_backlog <= 0:
            return []
        demand = live_units
        for r in self._queues["interactive"]:
            if r.arrival_step > step:
                break
            demand += unit_fn(r)
        kept: deque[Request] = deque()
        shed: list[Request] = []
        arrived = True
        for r in self._queues["batch"]:
            arrived = arrived and r.arrival_step <= step
            if not arrived:
                kept.append(r)
                continue
            need = unit_fn(r)
            if r.id in self._resumed:  # preempted work is admitted debt
                demand += need
                kept.append(r)
            elif demand + need > self.shed_backlog:
                shed.append(r)
                self.shed_count += 1
            else:
                demand += need
                kept.append(r)
        self._queues["batch"] = kept
        return shed
