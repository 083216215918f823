"""Block-granular KV pool, one device (port of ``BlockPagedKVPool`` in
``repro/serve/kv_cache.py``), fp or int8 (``kv_dtype``).

Device state: the shared block arenas of ``model.init_paged_cache``, and for
int8 arenas their per-block f32 scales.  Host state: per-slot positions,
per-slot block tables (a numpy mirror the engine uploads when
``tables_dirty``), FIFO free lists for slots and blocks, and per-slot
whole-request block reservations.

Reservation contract: ``allocate(reserve_tokens=n)`` admits a request only
after ``can_reserve(n)`` said the arena can cover its whole footprint
(prompt + decode budget); physical blocks are still handed out lazily by
``ensure`` as positions grow, so admission never deadlocks mid-decode.

Recycled blocks are not zeroed: every read is bounded by the causal mask and
the context length, and the GN softmax maps masked scores to numerators of
exactly zero, so stale contents are unreachable.  Scales are not zeroed
either: a recycled block's first write lands at in-block offset 0 and
freezes its scale anew.

Quarantine (the GN sentinels' containment, as the reference's):
``quarantine_block`` takes a block out of circulation for good.  A free
block leaves the free list at once; a block a live chain holds is marked
doomed and goes to the quarantine set, not the free list, when its slot is
freed.  ``scrub_blocks`` zeroes quarantined blocks' arena tiles and scales
in place (a NaN tile read through a stale table entry would poison a healthy
slot: 0 · NaN = NaN); the tensors keep their addresses, so captured graphs
keep reading them.  ``check_ledger`` holds free + held + quarantined =
num_blocks after every free and quarantine.  ``reset`` clears both sets.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device


class BlockPagedKVPool:
    def __init__(self, model, num_slots: int, max_seq: int, block_size: int,
                 num_blocks: int = 0, device=None, kv_dtype: str = "fp"):
        self.model = model
        self.kv_dtype = kv_dtype
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_blocks_per_slot = -(-self.max_seq // self.block_size)
        # 0 = slab-equivalent capacity (never admission-blocks)
        self.num_blocks = int(num_blocks) or self.num_slots * self.max_blocks_per_slot
        self.device = resolve_device(device)
        self.cache = model.init_paged_cache(self.num_blocks, self.block_size, self.device,
                                            kv_dtype)
        self.positions = np.zeros(self.num_slots, np.int32)
        # physical ids; entries past a slot's allocated prefix are stale but
        # never read (the kernel stops at the context length)
        self.tables = np.zeros((self.num_slots, self.max_blocks_per_slot), np.int32)
        self.reset()

    def reset(self) -> None:
        """Free everything and restore canonical slot and block order, so a
        reset engine replays a workload with identical slot assignment and
        block tables (stale arena contents and scales are mask-guarded or
        re-frozen, not zeroed)."""
        self.positions[:] = 0
        self.tables[:] = 0
        self.tables_dirty = True
        self._free_slots: deque[int] = deque(range(self.num_slots))
        self._free_blocks: deque[int] = deque(range(self.num_blocks))
        self._slot_blocks: dict[int, list[int]] = {}
        self._reserved = np.zeros(self.num_slots, np.int32)  # blocks, whole-request
        self.peak_blocks_in_use = 0
        # out of circulation for good; doomed: held by a live chain, bound for
        # quarantine when its slot is freed
        self.quarantined: set[int] = set()
        self._doomed: set[int] = set()

    def hbm_bytes(self) -> int:
        """Resident device bytes: the arenas (sink block included), the int8
        pool's scales, and the block tables."""
        return sum(t.numel() * t.element_size() for t in self.cache.values()) + self.tables.nbytes

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free_blocks) - len(self.quarantined)

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
        the FIFO free list in allocation order, doomed ones to quarantine."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} is not allocated")
        for b in self._slot_blocks.pop(slot):
            self._recycle(b)
        self.positions[slot] = 0
        self._reserved[slot] = 0
        self._free_slots.append(slot)
        self.check_ledger()

    def _recycle(self, block: int) -> None:
        if block in self._doomed:
            self._doomed.discard(block)
            self.quarantined.add(block)
        else:
            self._free_blocks.append(block)

    def chain_of(self, slot: int) -> list[int]:
        """A copy of ``slot``'s physical block chain, in logical order."""
        return list(self._slot_blocks[slot])

    def quarantine_block(self, block: int) -> None:
        """Take ``block`` out of circulation for good: a free block now, a
        held one (doomed) when its slot is freed.  Idempotent."""
        b = int(block)
        if b in self.quarantined or b in self._doomed:
            return
        if any(b in chain for chain in self._slot_blocks.values()):
            self._doomed.add(b)
            return
        try:
            self._free_blocks.remove(b)
        except ValueError:
            raise RuntimeError(f"block {b} is neither held nor free: ledger corrupt") from None
        self.quarantined.add(b)
        self.check_ledger()

    def scrub_blocks(self, blocks) -> None:
        """Zero the arena tiles and scales of ``blocks`` in every layer, in
        place.  A zeroed scale also reads as never written to the
        freeze-at-first-write quantizer."""
        blocks = sorted({int(b) for b in blocks})
        if not blocks:
            return
        ix = next(iter(self.cache.values())).new_tensor(blocks, dtype=torch.long)
        for leaf in self.cache.values():
            leaf.index_fill_(1, ix, 0)

    def check_ledger(self) -> None:
        """free + held + quarantined == num_blocks, doomed blocks held and
        quarantined ones not; raises on a leak."""
        held = {b for chain in self._slot_blocks.values() for b in chain}
        free, q = len(self._free_blocks), len(self.quarantined)
        if free + len(held) + q != self.num_blocks:
            raise RuntimeError(f"block ledger leak: free {free} + held {len(held)} + "
                               f"quarantined {q} != {self.num_blocks}")
        if not self._doomed <= held or self.quarantined & held:
            raise RuntimeError("a doomed block is not held, or a quarantined one is")

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
