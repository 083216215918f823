"""KV pools of the continuous engine (port of ``repro/serve/kv_cache.py``):
``SlotKVPool``, one slab a slot, and ``BlockPagedKVPool``, block-granular,
fp or int8 (``kv_dtype``), over one device or sharded over several.

``SlotKVPool`` holds ``model.init_cache(num_slots, max_seq)``: every leaf's
batch axis (axis 1, after the layers) is the slot axis, each slot a slab of
``max_seq`` positions or a sliding window's ring.  It is allocated once and
written in place (admission pages a fresh batch-1 cache into a slot with
``copy_``), so a captured tick keeps its addresses.  Host state: per-slot
positions and a FIFO free list of slots, restored to slot order by
``reset``.  Stale slab contents are never read: admission overwrites the
whole slot first.  It is the pool of the families whose KV does not page
(sliding windows; the SSM and hybrid families, whose leaves are the
per-layer carries, inserted, extracted on a spill and counted by
``hbm_bytes`` like any leaf, and the hybrid's shared K/V a group) and the
slab baseline of ``hbm_bytes``.

The block-paged pool:

Device state: the shared block arenas of ``model.init_paged_cache``, and for
int8 arenas their per-block f32 scales; every leaf has the block axis as
axis 1.  Host state: per-slot positions, per-slot block tables (a numpy
mirror the engine uploads when ``tables_dirty``), FIFO free lists for slots
and blocks, per-slot whole-request block reservations, and a refcount per
block.

Reservation contract: ``allocate(reserve_tokens=n)`` admits a request only
after ``can_reserve(n)`` said the arena can cover its whole footprint
(prompt + decode budget); physical blocks are still handed out lazily by
``ensure`` as positions grow, so admission never deadlocks mid-decode.

Recycled blocks are not zeroed: every read is bounded by the causal mask and
the context length, and the GN softmax maps masked scores to numerators of
exactly zero, so stale contents are unreachable.  Scales are not zeroed
either: a recycled block's first write lands at in-block offset 0 and
freezes its scale anew.

Prefix sharing (``attach_prefix_cache``): a slot owns the blocks ``ensure``
popped for it (refcount 1), attaches cached full blocks of a ``PrefixHit``
read-only (refcount + 1), and the cache holds one reference per indexed
block; a block returns to the FIFO free list only at refcount 0, so
recycling order is unchanged when nothing is shared.  A reservation charges
only the unshared tail, and a partially shared block is forked (copied into
a private block) when the slot attaches, before its first write
(``write_barrier`` asserts no live slot writes a shared block).  Under block
pressure ``_pop_block`` reclaims the cache's LRU cache-only blocks.

Extras (encdec, VLM): ``extras`` holds the model's slot-batched extra
leaves (``model.init_paged_extras``: cross k and v, or patches), written at
admission by ``insert_extras``; they have no block axis, so forks, spills
and scrubs leave them to the slot.  The slab pool's cache holds them among
its leaves.

Every device write here is in place (``copy_``, ``index_copy_``,
``index_fill_``): the fork, the preemption restore and the scrub keep the
arenas' addresses, so the engine's captured tick graphs keep reading them.

Quarantine (the GN sentinels' containment, as the reference's):
``quarantine_block`` takes a block out of circulation for good.  A free
block leaves the free list at once; a live one (refcount > 0) is marked
doomed and goes to the quarantine set, not the free list, when its last
reference drops.  ``scrub_blocks`` zeroes quarantined blocks' arena tiles
and scales (a NaN tile read through a stale table entry would poison a
healthy slot: 0 · NaN = NaN).  ``check_ledger`` holds free + live
(refcount > 0) + quarantined = num_blocks after every recycle and
quarantine.  ``reset`` clears both sets and the prefix index.

Shards (``num_devices`` > 1, the reference's slot-axis mesh): device d owns
the contiguous slot range [d * per_device_slots, (d + 1) * per_device_slots)
and, in the paged pool, the contiguous block range [d * blocks_per_device,
(d + 1) * blocks_per_device); a slot only ever takes blocks of its own
device, so a sequence's KV stays with its slot.  ``device`` is one device
(one shard) or a list of them, one a shard (``parallel.sharding.
make_slot_mesh``; the CPU tests list ``"cpu"`` N times).  Each shard's
leaves live on its device: ``caches[d]`` (the slab rows of its slots, or the arenas of its
block range with a write sink of its own, local block ids 0 ..
blocks_per_device) and the paged pool's ``extras_shards[d]``.  The host
ledger keeps the reference's global ids (tables, refcounts, free lists,
the prefix index); ``local_tables`` gives a shard's table rows in its local
ids for the upload.  Admission is least-loaded (``pick_device``: the most
free slots, paged also a block range that covers the reservation, ties to
the lowest device); each device recycles its own FIFO block list and keeps
its own reservations.  ``mark_device_lost`` quarantines a device's whole
block range and retires its slots.  With one device every range is the
whole pool and the pool is the unsharded one.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device


class _SlotRanges:
    """Per-device slot ranges, shared by both pools (the reference's): device
    d owns slots [d * per_device_slots, (d + 1) * per_device_slots); with one
    device the one range is the whole pool."""

    def _init_ranges(self, num_slots: int, device) -> None:
        self.devices = [resolve_device(d) for d in
                        (device if isinstance(device, (list, tuple)) else [device])]
        self.device = self.devices[0]
        self.num_devices = len(self.devices)
        if num_slots % self.num_devices:
            raise ValueError(f"num_slots {num_slots} must divide evenly over "
                             f"{self.num_devices} devices (per-device slot shards)")
        self.per_device_slots = num_slots // self.num_devices

    def device_of(self, slot: int) -> int:
        return int(slot) // self.per_device_slots

    def local(self, slot: int) -> tuple[int, int]:
        """(device, slot index within the device's shard)."""
        return divmod(int(slot), self.per_device_slots)

    def free_slots_on(self, device: int) -> int:
        lo = device * self.per_device_slots
        return sum(1 for s in self._free_slot_list() if lo <= s < lo + self.per_device_slots)

    def _pop_free_slot(self, device: Optional[int]) -> int:
        """The oldest free slot, in ``device``'s range when one is named (FIFO
        within the range, so one device allocates in the global FIFO order)."""
        free = self._free_slot_list()
        if not free:
            raise RuntimeError(f"{type(self).__name__} exhausted: no free slot")
        if device is None:
            return free.popleft()
        lo = device * self.per_device_slots
        for slot in free:
            if lo <= slot < lo + self.per_device_slots:
                free.remove(slot)
                return slot
        raise RuntimeError(f"{type(self).__name__}: no free slot on device {device}")


def _leaves_bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


class SlotKVPool(_SlotRanges):
    def __init__(self, model, num_slots: int, max_seq: int, device=None):
        self.model = model
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self._init_ranges(self.num_slots, device)
        self.caches = [model.init_cache(self.per_device_slots, self.max_seq, dev)
                       for dev in self.devices]
        self.positions = np.zeros(self.num_slots, np.int32)
        self.reset()

    def _free_slot_list(self) -> deque:
        return self._free

    def reset(self) -> None:
        """Free every slot and restore the slot order, so a reset engine
        assigns slots as a fresh one (stale slab contents stay: admission
        overwrites a slot whole before any read)."""
        self.positions[:] = 0
        self._free: deque[int] = deque(range(self.num_slots))
        self._used: set[int] = set()

    def hbm_bytes(self) -> int:
        """Resident device bytes of the slab caches (KV slabs or carries, and
        the extra leaves), every shard's."""
        return sum(_leaves_bytes(c.values()) for c in self.caches)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._used)

    def pick_device(self, reserve_tokens: int = 0) -> Optional[int]:
        """The least-loaded device (most free slots; ties to the lowest), or
        None when no device has a free slot.  ``reserve_tokens`` is ignored:
        a slab reserves nothing."""
        best, best_free = None, 0
        for d in range(self.num_devices):
            free = self.free_slots_on(d)
            if free > best_free:
                best, best_free = d, free
        return best

    def allocate(self, device: Optional[int] = None) -> int:
        slot = self._pop_free_slot(device)
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        self._used.remove(slot)
        self.positions[slot] = 0
        self._free.append(slot)

    def insert(self, request_cache: dict, slot: int, position: int) -> None:
        """Copy a batch-1 cache (``model.fresh_request_cache`` or a spilled
        ``extract``, on any device) into ``slot``'s row in place;
        ``position`` is its next write position."""
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not allocated")
        if position > self.max_seq:
            raise ValueError(f"position {position} exceeds max_seq {self.max_seq}")
        d, row = self.local(slot)
        self.model.insert_cache_slot(self.caches[d], request_cache, row)
        self.positions[slot] = position

    def extract(self, slot: int) -> dict:
        """``slot``'s row as a batch-1 copy (preemption's spill)."""
        d, row = self.local(slot)
        return self.model.extract_cache_slot(self.caches[d], row)

    def advance(self, slots: dict) -> None:
        """Advance positions by {slot: tokens committed this tick}."""
        for slot, n in slots.items():
            new = int(self.positions[slot]) + int(n)
            if new > self.max_seq:
                raise ValueError(f"slot {slot}: position {new} exceeds max_seq {self.max_seq}")
            self.positions[slot] = new


class BlockPagedKVPool(_SlotRanges):
    def __init__(self, model, num_slots: int, max_seq: int, block_size: int,
                 num_blocks: int = 0, device=None, kv_dtype: str = "fp"):
        self.model = model
        self.kv_dtype = kv_dtype
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._init_ranges(self.num_slots, device)
        self.max_blocks_per_slot = -(-self.max_seq // self.block_size)
        # 0 = slab-equivalent capacity (never admission-blocks); rounded up to
        # a device multiple so every device owns an equal block range
        nb = int(num_blocks) or self.num_slots * self.max_blocks_per_slot
        self.num_blocks = -(-nb // self.num_devices) * self.num_devices
        self.blocks_per_device = self.num_blocks // self.num_devices
        self.caches = [model.init_paged_cache(self.blocks_per_device, self.block_size, dev,
                                              kv_dtype) for dev in self.devices]
        self.extras_shards = [model.init_paged_extras(self.per_device_slots, dev)
                              for dev in self.devices]
        self.positions = np.zeros(self.num_slots, np.int32)
        # physical ids; entries past a slot's allocated prefix are stale but
        # never read (the kernel stops at the context length)
        self.tables = np.zeros((self.num_slots, self.max_blocks_per_slot), np.int32)
        self.prefix_cache = None  # bound by attach_prefix_cache
        self.reset()

    def _free_slot_list(self) -> deque:
        return self._free_slots

    def reset(self) -> None:
        """Free everything and restore canonical slot and block order on every
        device, so a reset engine replays a workload with identical slot
        assignment and block tables (stale arena contents and scales are
        mask-guarded or re-frozen, not zeroed); the prefix index is cleared
        too."""
        self.positions[:] = 0
        self.tables[:] = 0
        self.tables_dirty = True
        self._free_slots: deque[int] = deque(range(self.num_slots))
        # a FIFO block list a device: device d recycles only its own range
        bpd = self.blocks_per_device
        self._free_blocks: list[deque[int]] = [deque(range(d * bpd, (d + 1) * bpd))
                                               for d in range(self.num_devices)]
        self._slot_blocks: dict[int, list[int]] = {}
        self._reserved = np.zeros(self.num_slots, np.int32)  # blocks, whole-request
        # owner = 1, each sharing attach and each index entry + 1
        self.refcounts = np.zeros(self.num_blocks, np.int32)
        self._shared = np.zeros(self.num_slots, np.int32)  # attached, not owned
        self._owned = np.zeros(self.num_slots, np.int32)   # popped for the slot
        self.prefix_forks = 0
        self.prefix_evictions = 0
        self.peak_blocks_in_use = 0
        self.peak_blocks_reserved = 0
        # per-device peaks of the reservations and of the blocks in use
        self.peak_reserved_per_device = np.zeros(self.num_devices, np.int64)
        self.peak_used_per_device = np.zeros(self.num_devices, np.int64)
        # out of circulation for good; doomed: live, bound for quarantine
        # when its last reference drops
        self.quarantined: set[int] = set()
        self._doomed: set[int] = set()
        self._lost_devices: set[int] = set()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.check_ledger()

    def hbm_bytes(self) -> int:
        """Resident device bytes: every shard's arenas (its sink block
        included), the int8 pool's scales, the slot-batched extras (cross
        KV, patches) and the block tables."""
        return (sum(_leaves_bytes([*c.values(), *e.values()])
                    for c, e in zip(self.caches, self.extras_shards)) + self.tables.nbytes)

    def shard_of_block(self, block: int) -> tuple[int, int]:
        """(device, local id in the device's arenas) of a global block id."""
        return divmod(int(block), self.blocks_per_device)

    def local_tables(self, device: int, width: int) -> np.ndarray:
        """``device``'s table rows (its slots), ``width`` columns, in its
        arenas' local ids.  A stale entry of another range (a row's initial
        zeros past its chain) becomes local block 0: it is never read."""
        lo = device * self.per_device_slots
        rows = self.tables[lo:lo + self.per_device_slots, :width]
        if self.num_devices == 1:
            return rows
        local = rows - device * self.blocks_per_device
        return np.where((local >= 0) & (local < self.blocks_per_device), local, 0).astype(np.int32)

    def insert_extras(self, slot: int, request_extras: dict) -> None:
        """Write a request's batch-1 extra leaves into ``slot``'s row, in
        place (nothing for a model without extras)."""
        d, row = self.local(slot)
        self.model.insert_cache_slot_extras(self.extras_shards[d], request_extras, row)

    @property
    def num_free(self) -> int:
        return len(self._free_slots)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - sum(len(f) for f in self._free_blocks)
                - len(self.quarantined))

    @property
    def blocks_reserved(self) -> int:
        return int(self._reserved.sum())

    @property
    def max_request_blocks(self) -> int:
        """The largest footprint one request can hold: a slot's blocks all
        come from its own device's range."""
        return self.blocks_per_device

    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_size)

    def free_blocks_on(self, device: int) -> int:
        return len(self._free_blocks[device])

    def quarantined_on(self, device: int) -> int:
        lo = device * self.blocks_per_device
        return sum(1 for b in self.quarantined if lo <= b < lo + self.blocks_per_device)

    def blocks_in_use_on(self, device: int) -> int:
        return (self.blocks_per_device - len(self._free_blocks[device])
                - self.quarantined_on(device))

    def reserved_on(self, device: int) -> int:
        lo = device * self.per_device_slots
        return int(self._reserved[lo:lo + self.per_device_slots].sum())

    def unfilled_on(self, device: int) -> int:
        """Blocks promised to ``device``'s live slots and not yet popped for
        them: per slot, reserved minus owned (cached and shared blocks belong
        to no reservation)."""
        lo = device * self.per_device_slots
        hi = lo + self.per_device_slots
        return int((self._reserved[lo:hi] - self._owned[lo:hi]).sum())

    def can_reserve(self, tokens: int, device: int = 0, prefix=None) -> bool:
        """True if ``device``'s block range can cover a ``tokens``-long
        request: its free blocks, plus the cache's evictable ones there, minus
        what its live slots were promised and have not yet taken.  A
        ``prefix`` hit discounts its fully shared blocks (attached, not
        allocated) and takes the hit's own blocks out of the evictable supply
        (attaching pins them, the fork source too).  A lost device takes
        nothing."""
        if device in self._lost_devices:
            return False
        need = self.blocks_for(tokens)
        avail = len(self._free_blocks[device])
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_count(device, self.refcounts)
        if prefix is not None:
            need -= len(prefix.blocks)
            held = list(prefix.blocks) + ([prefix.tail_src] if prefix.tail_src is not None
                                          else [])
            avail -= sum(1 for b in held if self.refcounts[b] == 1)
        return avail - self.unfilled_on(device) >= need

    def pick_device(self, reserve_tokens: int = 0) -> Optional[int]:
        """The least-loaded device (most free slots; ties to the lowest) whose
        block range also covers a ``reserve_tokens`` reservation; None when
        no device can take the request (the head waits for recycling)."""
        best, best_free = None, 0
        for d in range(self.num_devices):
            if d in self._lost_devices:
                continue
            free = self.free_slots_on(d)
            if free <= best_free:
                continue
            if reserve_tokens and not self.can_reserve(reserve_tokens, d):
                continue
            best, best_free = d, free
        return best

    def allocate(self, reserve_tokens: int = 0, device: Optional[int] = None,
                 prefix=None) -> int:
        """A free slot (of ``device``'s range, else the FIFO head) reserving
        ``reserve_tokens``' blocks on its device, less the blocks ``prefix``
        attaches (its fork block still counts: it is allocated).  A refused
        reservation puts the slot back at the head."""
        need = self.blocks_for(reserve_tokens) - (len(prefix.blocks) if prefix else 0)
        slot = self._pop_free_slot(device)
        dev = self.device_of(slot)
        if reserve_tokens and not self.can_reserve(reserve_tokens, dev, prefix):
            self._free_slots.appendleft(slot)
            raise RuntimeError(
                f"BlockPagedKVPool exhausted: {need} blocks wanted on device {dev}, "
                f"{len(self._free_blocks[dev])} free minus {self.unfilled_on(dev)} reserved")
        self._slot_blocks[slot] = []
        self._reserved[slot] = need
        self._shared[slot] = self._owned[slot] = 0
        self.peak_blocks_reserved = max(self.peak_blocks_reserved, self.blocks_reserved)
        self.peak_reserved_per_device[dev] = max(self.peak_reserved_per_device[dev],
                                                 self.reserved_on(dev))
        return slot

    def free(self, slot: int) -> None:
        """Release a slot's references the tick its request finishes: blocks
        at refcount 0 return to their device's FIFO free list in chain order
        (doomed ones to quarantine); blocks the cache or another slot holds
        stay.  A lost device's slot does not return to admission."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} is not allocated")
        for b in self._slot_blocks.pop(slot):
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                self._recycle(b)
        self.positions[slot] = 0
        self._reserved[slot] = self._shared[slot] = self._owned[slot] = 0
        if self.device_of(slot) not in self._lost_devices:
            self._free_slots.append(slot)
        self.check_ledger()

    def _recycle(self, block: int) -> None:
        if block in self._doomed:
            self._doomed.discard(block)
            self.quarantined.add(block)
        else:
            self._free_blocks[block // self.blocks_per_device].append(block)

    def chain_of(self, slot: int) -> list[int]:
        """A copy of ``slot``'s physical block chain, in logical order."""
        return list(self._slot_blocks[slot])

    def quarantine_block(self, block: int) -> None:
        """Take ``block`` out of circulation for good: a free block now, a
        live one (refcount > 0, held by a chain or only by the prefix index)
        when its last reference drops.  Idempotent."""
        b = int(block)
        if b in self.quarantined or b in self._doomed:
            return
        if self.refcounts[b] > 0:
            self._doomed.add(b)
            return
        try:
            self._free_blocks[b // self.blocks_per_device].remove(b)
        except ValueError:
            raise RuntimeError(f"block {b} is neither live nor free: ledger corrupt") from None
        self.quarantined.add(b)
        self.check_ledger()

    def mark_device_lost(self, device: int) -> None:
        """Retire a device: quarantine its whole block range (its live blocks
        doomed, quarantined as their slots free) and drop its free slots
        from admission; the engine recovers its live slots."""
        dev = int(device)
        if dev in self._lost_devices:
            return
        self._lost_devices.add(dev)
        lo = dev * self.blocks_per_device
        for b in range(lo, lo + self.blocks_per_device):
            self.quarantine_block(b)
        slo = dev * self.per_device_slots
        for s in [s for s in self._free_slots if slo <= s < slo + self.per_device_slots]:
            self._free_slots.remove(s)
        self.check_ledger()

    def scrub_blocks(self, blocks) -> None:
        """Zero the arena tiles and scales of ``blocks`` in every layer, in
        place, each on its device.  A zeroed scale also reads as never
        written to the freeze-at-first-write quantizer."""
        per_dev: dict[int, list[int]] = {}
        for b in sorted({int(b) for b in blocks}):
            d, local = self.shard_of_block(b)
            per_dev.setdefault(d, []).append(local)
        for d, local in per_dev.items():
            ix = torch.tensor(local, dtype=torch.long, device=self.devices[d])
            for leaf in self.caches[d].values():
                leaf.index_fill_(1, ix, 0)

    def check_ledger(self) -> None:
        """free + live (refcount > 0) + quarantined == num_blocks, doomed
        blocks live and quarantined ones unreferenced; raises on a leak."""
        free, q = sum(len(f) for f in self._free_blocks), len(self.quarantined)
        live = int((self.refcounts > 0).sum())
        if free + live + q != self.num_blocks:
            raise RuntimeError(f"block ledger leak: free {free} + live {live} + "
                               f"quarantined {q} != {self.num_blocks}")
        if any(self.refcounts[b] <= 0 for b in self._doomed):
            raise RuntimeError("a doomed block has refcount <= 0 and was never recycled")
        if any(self.refcounts[b] != 0 for b in self.quarantined):
            raise RuntimeError("a quarantined block is still referenced")

    def active_horizon_blocks(self) -> int:
        """Max blocks any live slot holds right now (0 when none does)."""
        return max((len(b) for b in self._slot_blocks.values()), default=0)

    def ensure(self, slot: int, position: int) -> None:
        """Grow ``slot``'s block table to cover positions [0, position) from
        its device's range (attached shared blocks are free growth: no
        reservation paid them)."""
        if position > self.max_seq:
            raise ValueError(f"position {position} exceeds max_seq {self.max_seq}")
        blocks = self._slot_blocks[slot]
        need = self.blocks_for(position)
        if need - self._shared[slot] > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: {need} blocks exceed its reservation "
                f"{int(self._reserved[slot])} + {int(self._shared[slot])} shared; "
                "allocate(reserve_tokens=...) must cover the full prompt + decode footprint")
        dev = self.device_of(slot)
        while len(blocks) < need:
            b = self._pop_block(dev, f"mid-sequence (slot {slot})")
            self.refcounts[b] = 1
            self._owned[slot] += 1
            self.tables[slot, len(blocks)] = b
            blocks.append(b)
            self.tables_dirty = True

    def _pop_block(self, dev: int, context: str) -> int:
        """The oldest free block on ``dev``, reclaiming the cache's LRU
        cache-only blocks there under pressure; admission's accounting makes
        a failure here a bug, not a load condition."""
        if not self._free_blocks[dev] and self.prefix_cache is not None:
            evicted = self.prefix_cache.evict_lru(dev, self.refcounts)
            if evicted is not None:
                self.prefix_evictions += 1
                self.cache_unref(evicted)
        if not self._free_blocks[dev]:
            raise RuntimeError(f"BlockPagedKVPool exhausted {context} (device {dev}): "
                               "reservation accounting should have prevented this")
        b = self._free_blocks[dev].popleft()
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        self.peak_used_per_device[dev] = max(self.peak_used_per_device[dev],
                                             self.blocks_in_use_on(dev))
        return b

    def insert(self, slot: int, position: int) -> None:
        """Start ``slot`` at ``position`` (0 for a fresh prefill, the shared
        length after a prefix attach, a spilled request's position before
        its restore), its chain ensured to cover it."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} is not allocated")
        if position > self.max_seq:
            raise ValueError(f"position {position} exceeds max_seq {self.max_seq}")
        self.positions[slot] = position
        if position:
            self.ensure(slot, position)

    def advance(self, slots: dict) -> None:
        """Advance positions by {slot: tokens committed this tick}."""
        for slot, n in slots.items():
            new = int(self.positions[slot]) + int(n)
            if new > self.max_seq:
                raise ValueError(f"slot {slot}: position {new} exceeds max_seq {self.max_seq}")
            self.positions[slot] = new

    # ------------------------------------------------------- prefix sharing --
    def attach_prefix_cache(self, cache) -> None:
        """Bind a ``PrefixCache``: it indexes this pool's blocks (one
        reference per entry) and the pool reclaims its LRU cache-only blocks
        under pressure."""
        self.prefix_cache = cache
        cache.pool = self

    def cache_ref(self, block: int) -> None:
        self.refcounts[block] += 1

    def cache_unref(self, block: int) -> None:
        self.refcounts[block] -= 1
        if self.refcounts[block] == 0:
            self._recycle(int(block))
            self.check_ledger()

    @property
    def cached_blocks(self) -> int:
        return 0 if self.prefix_cache is None else self.prefix_cache.cached_blocks()

    def attach_prefix(self, slot: int, prefix) -> None:
        """Wire a freshly allocated slot to a ``PrefixHit`` of its device: the
        fully matched blocks attach read-only (refcount + 1), and a partially
        matched tail block is forked now into a block the slot owns, before
        the slot can write into it.  The fork source is pinned across the
        fork's pop."""
        if slot not in self._slot_blocks or self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} must be freshly allocated")
        dev = self.device_of(slot)
        chain = self._slot_blocks[slot]
        for b in list(prefix.blocks) + ([prefix.tail_src] if prefix.tail_src is not None
                                        else []):
            if b // self.blocks_per_device != dev:
                raise ValueError(f"prefix block {b} is not on slot {slot}'s device {dev}")
        for b in prefix.blocks:
            self.refcounts[b] += 1
            self.tables[slot, len(chain)] = b
            chain.append(b)
        self._shared[slot] = len(prefix.blocks)
        if prefix.tail_src is not None:
            self.refcounts[prefix.tail_src] += 1
            dst = self._pop_block(dev, f"forking for slot {slot}")
            self.refcounts[dst] = 1
            self._owned[slot] += 1
            self.tables[slot, len(chain)] = dst
            chain.append(dst)
            self.fork_block(prefix.tail_src, dst)
            self.refcounts[prefix.tail_src] -= 1
            self.prefix_forks += 1
        self.tables_dirty = True

    def fork_block(self, src: int, dst: int) -> None:
        """Copy block ``src`` onto block ``dst`` (one device's) in every leaf,
        in place: the arenas in every layer and, over an int8 pool, the
        scales (a forked block keeps its donor's frozen scale: the tenant's
        first write lands past offset 0, so no write refreezes it)."""
        d, s = self.shard_of_block(src)
        dd, t = self.shard_of_block(dst)
        if d != dd:
            raise ValueError(f"fork across devices: block {src} on {d}, {dst} on {dd}")
        for leaf in self.caches[d].values():
            leaf[:, t].copy_(leaf[:, s])

    def write_barrier(self, slot: int, position: int) -> None:
        """The block ``slot``'s next write lands in must be its own
        (refcount 1); attach-time forking makes this hold by construction,
        so a trip is a sharing bug."""
        idx = int(position) // self.block_size
        chain = self._slot_blocks.get(slot, ())
        if idx < len(chain) and self.refcounts[chain[idx]] != 1:
            raise RuntimeError(f"COW violation: slot {slot} would write block {chain[idx]} "
                               f"with refcount {int(self.refcounts[chain[idx]])}")

    # ------------------------------------------------------ preemption spill --
    def _spill_pad(self, n: int) -> int:
        """A chain length padded to the next power of two (at most
        ``max_blocks_per_slot``): the reference's payload shape."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_blocks_per_slot)

    def _chain_index(self, slot: int, chain: list[int]) -> tuple[dict, torch.Tensor]:
        """The arenas of ``slot``'s device and ``chain`` in their local ids."""
        d = self.device_of(slot)
        off = d * self.blocks_per_device
        return self.caches[d], torch.tensor([b - off for b in chain], dtype=torch.long,
                                            device=self.devices[d])

    def extract_blocks(self, slot: int) -> dict:
        """Copy ``slot``'s chain out of the arenas (and scales) into host
        memory: ``{"len": n, "layers": {leaf: (L, n_padded, ...) tensor}}``,
        lanes past ``n`` repeating the last block.  The payload is values
        only: a restore into other physical blocks is exact."""
        chain = self.chain_of(slot)
        if not chain:
            return {"len": 0, "layers": None}
        idx = chain + [chain[-1]] * (self._spill_pad(len(chain)) - len(chain))
        arenas, ix = self._chain_index(slot, idx)
        return {"len": len(chain),
                "layers": {k: leaf.index_select(1, ix).cpu() for k, leaf in arenas.items()}}

    def restore_blocks(self, slot: int, payload: dict) -> None:
        """Copy a spilled payload into ``slot``'s freshly ensured chain, in
        place.  Lanes past ``len`` name the last block again with its own
        values, so the duplicate indices carry equal data."""
        n = int(payload["len"])
        if n == 0:
            return
        chain = self._slot_blocks[slot]
        if len(chain) < n:
            raise ValueError(f"slot {slot}: restore needs {n} blocks ensured, the chain has "
                             f"{len(chain)}: call insert(slot, position) first")
        idx = chain[:n] + [chain[n - 1]] * (self._spill_pad(n) - n)
        arenas, ix = self._chain_index(slot, idx)
        for k, leaf in arenas.items():
            leaf.index_copy_(1, ix, payload["layers"][k].to(leaf.device))
