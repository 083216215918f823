"""Block-granular KV pool, fp, one device (port of ``BlockPagedKVPool`` in
``repro/serve/kv_cache.py``).

Device state: the shared block arenas of ``model.init_paged_cache``.  Host
state: per-slot positions, per-slot block tables (a numpy mirror the engine
uploads when ``tables_dirty``), FIFO free lists for slots and blocks, and
per-slot whole-request block reservations.

Reservation contract: ``allocate(reserve_tokens=n)`` admits a request only
after ``can_reserve(n)`` said the arena can cover its whole footprint
(prompt + decode budget); physical blocks are still handed out lazily by
``ensure`` as positions grow, so admission never deadlocks mid-decode.

Recycled blocks are not zeroed: every read is bounded by the causal mask and
the context length, and the GN softmax maps masked scores to numerators of
exactly zero, so stale contents are unreachable.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch import resolve_device


class BlockPagedKVPool:
    def __init__(self, model, num_slots: int, max_seq: int, block_size: int,
                 num_blocks: int = 0, device=None):
        self.model = model
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_blocks_per_slot = -(-self.max_seq // self.block_size)
        # 0 = slab-equivalent capacity (never admission-blocks)
        self.num_blocks = int(num_blocks) or self.num_slots * self.max_blocks_per_slot
        self.device = resolve_device(device)
        self.cache = model.init_paged_cache(self.num_blocks, self.block_size, self.device)
        self.positions = np.zeros(self.num_slots, np.int32)
        # physical ids; entries past a slot's allocated prefix are stale but
        # never read (the kernel stops at the context length)
        self.tables = np.zeros((self.num_slots, self.max_blocks_per_slot), np.int32)
        self.reset()

    def reset(self) -> None:
        """Free everything and restore canonical slot and block order, so a
        reset engine replays a workload with identical slot assignment and
        block tables (stale arena contents are mask-guarded, not zeroed)."""
        self.positions[:] = 0
        self.tables[:] = 0
        self.tables_dirty = True
        self._free_slots: deque[int] = deque(range(self.num_slots))
        self._free_blocks: deque[int] = deque(range(self.num_blocks))
        self._slot_blocks: dict[int, list[int]] = {}
        self._reserved = np.zeros(self.num_slots, np.int32)  # blocks, whole-request
        self.peak_blocks_in_use = 0

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free_blocks)

    @property
    def blocks_reserved(self) -> int:
        return int(self._reserved.sum())

    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_size)

    def can_reserve(self, tokens: int) -> bool:
        """True if the free blocks, minus what live slots were promised but
        have not yet taken, cover a ``tokens``-long request."""
        unfilled = self.blocks_reserved - self.blocks_in_use
        return len(self._free_blocks) - unfilled >= self.blocks_for(tokens)

    def allocate(self, reserve_tokens: int = 0) -> int:
        if not self._free_slots:
            raise RuntimeError("BlockPagedKVPool: no free slot")
        if reserve_tokens and not self.can_reserve(reserve_tokens):
            raise RuntimeError(
                f"BlockPagedKVPool exhausted: {self.blocks_for(reserve_tokens)} blocks "
                f"wanted, {len(self._free_blocks)} free minus "
                f"{self.blocks_reserved - self.blocks_in_use} reserved")
        slot = self._free_slots.popleft()
        self._slot_blocks[slot] = []
        self._reserved[slot] = self.blocks_for(reserve_tokens)
        return slot

    def free(self, slot: int) -> None:
        """Release a slot the tick its request finishes: its blocks return to
        the FIFO free list in allocation order."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} is not allocated")
        self._free_blocks.extend(self._slot_blocks.pop(slot))
        self.positions[slot] = 0
        self._reserved[slot] = 0
        self._free_slots.append(slot)
        held = sum(len(b) for b in self._slot_blocks.values())
        if len(self._free_blocks) + held != self.num_blocks:
            raise RuntimeError(f"block ledger leak: free {len(self._free_blocks)} + "
                               f"held {held} != {self.num_blocks}")

    def active_horizon_blocks(self) -> int:
        """Max blocks any live slot holds right now (0 when none does)."""
        return max((len(b) for b in self._slot_blocks.values()), default=0)

    def ensure(self, slot: int, position: int) -> None:
        """Grow ``slot``'s block table to cover positions [0, position)."""
        if position > self.max_seq:
            raise ValueError(f"position {position} exceeds max_seq {self.max_seq}")
        blocks = self._slot_blocks[slot]
        need = self.blocks_for(position)
        if need > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: {need} blocks exceed its reservation "
                f"{int(self._reserved[slot])}; allocate(reserve_tokens=...) must cover "
                "the full prompt + decode footprint")
        while len(blocks) < need:
            b = self._free_blocks.popleft()
            self.tables[slot, len(blocks)] = b
            blocks.append(b)
            self.tables_dirty = True
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)

    def advance(self, slots: dict) -> None:
        """Advance positions by {slot: tokens committed this tick}."""
        for slot, n in slots.items():
            new = int(self.positions[slot]) + int(n)
            if new > self.max_seq:
                raise ValueError(f"slot {slot}: position {new} exceeds max_seq {self.max_seq}")
            self.positions[slot] = new
