"""Request/Completion API + FCFS admission scheduler (port of the FCFS part
of ``repro/serve/scheduler.py``).

Requests are admitted strictly in submission order, each as soon as its
arrival step has been reached on the engine clock and the pool can take it.
The clock is the engine's tick counter, so a seeded workload replays
identically.  Prompts are bucketed to the fused step's chunk grid at submit.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

# the closed set of completion verdicts: 'length' = decode budget spent,
# 'stop' = stop token, 'failed' = the GN sentinels' retry budget spent (the
# fault record is in the engine's event log).  The reference's 'rejected'
# (load shedding) is not ported.
FINISH_REASONS = ("length", "stop", "failed")


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
    ``arrival_step`` stamps when it becomes visible on the engine clock."""

    tokens: np.ndarray
    max_new_tokens: int = 16
    temperature: Optional[float] = None  # None -> engine default
    stop_token: Optional[int] = None
    arrival_step: int = 0
    id: int = -1  # assigned by the scheduler on submit
    padded_tokens: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

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
    admit_step: int
    first_token_step: int
    finish_step: int
    admit_time: float
    first_token_time: float
    finish_time: float

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
        """Engine steps spent waiting for admission (arrival -> admit)."""
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
        uninterrupted decode; a recompute resume inflates it); 0.0 below two
        tokens."""
        n = int(np.asarray(self.new_tokens).shape[0])
        if n < 2:
            return 0.0
        return (self.finish_step - self.first_token_step) / (n - 1)


class FCFSScheduler:
    """First-come-first-served admission; the head of the queue blocks, so
    admission order (and slot assignment) is deterministic."""

    def __init__(self, chunk_grid: int = 0):
        self.chunk_grid = int(chunk_grid)
        self._queue: deque[Request] = deque()
        self._next_id = 0
        self._pad_tokens = 0  # total intake padding (bucketing overhead)

    def submit(self, req: Request) -> int:
        """Enqueue a bucketed *copy* of ``req`` and return its id."""
        if req.max_new_tokens < 1:
            raise ValueError(f"request needs max_new_tokens >= 1, got {req.max_new_tokens}")
        rid = req.id if req.id >= 0 else self._next_id
        self._next_id = max(self._next_id, rid) + 1
        queued = dataclasses.replace(req, id=rid)
        queued.padded_tokens = (
            pad_to_grid(queued.tokens, self.chunk_grid) if self.chunk_grid else None
        )
        if self.chunk_grid:
            self._pad_tokens += int(queued.padded_tokens.shape[0]) - queued.prompt_len
        self._queue.append(queued)
        return rid

    @property
    def intake_padding(self) -> int:
        """Total pad tokens added by bucketing (<= grid - 1 per request)."""
        return self._pad_tokens

    def requeue_front(self, req: Request) -> None:
        """Put an already submitted request back at the head of the queue
        (a fault-evicted request keeps its id, padding and arrival)."""
        self._queue.appendleft(req)

    def next_ready_step(self) -> Optional[int]:
        """Arrival step of the head (FCFS is head-blocking), or None."""
        return self._queue[0].arrival_step if self._queue else None

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
