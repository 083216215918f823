"""Deterministic fault injection for the block-paged serving engine (port of
``repro/serve/faults.py``).

The injector corrupts engine state between ticks.  Arena and scale faults
are written in place on the device, into the pool's own tensors (a global
block id addresses its device's arenas at its local id), so the tick's
captured graphs read them on their next replay; no host copy of an arena
is made.  Targets are drawn from ``np.random.default_rng(seed)`` in
the reference's order (leaf names sorted, then slot, block and layer), and
block tables are bitwise the reference's, so one seed hits the same
(leaf, slot, block, layer) in both packages.

Fault classes and the sentinel channel that catches each:

``nan_tile`` / ``inf_tile``
    One (layer, block) tile of a live slot's chain set to NaN or +Inf; fp
    arenas only (an int8 arena cannot hold them: ``scale`` is its channel).
    A V tile reaches the read's output and every read's probe catches it.
    A K tile turns the scores nonfinite, and the GN exponential launders
    them into a valid distribution: the full Σp probe of the streamed and
    gathered reads sees the scores, the kernel read its per-row flag of a
    nonfinite live score (its output stays finite).
``scale``
    One per-block int8 dequant scale set to one of {NaN, +Inf, -1.0, 1e6}:
    the scale-sanity channel.
``table``
    One live block-table entry pointed at another valid block: repaired by
    the engine's check against the chain before the upload.
``bit_flip``
    The lowest bit of one byte of one arena tile.  The detection floor: GN
    renormalizes any finite score set to Σp = 1, so the read stays valid
    over an almost-right value; recorded with ``detectable=False``.
``device_loss``
    NaN over a whole device's block range in its fp arenas (every arena
    leaf, whatever ``leaves`` says, every layer; the sink block is left), so
    every live slot there violates in one tick and the engine declares the
    device lost.  A device with at least ``device_loss_min_slots`` live slots
    is drawn; None on one device or when no device has that many, as the
    reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class FaultRecord:
    """One injected fault; ``step`` is the engine's step_count at injection,
    the origin of its detection latency."""

    kind: str
    step: int
    slot: int = -1      # victim slot (-1: not slot-targeted)
    block: int = -1     # physical block id (-1: not block-targeted)
    layer: int = -1     # arena layer (-1: all / n.a.)
    leaf: str = ""      # arena leaf name ('k', 'v', 'k_scale', ...)
    device: int = -1    # device_loss only
    value: str = ""     # the poison ('nan', 'inf', '-1.0', '1e6', ...)
    detectable: bool = True


class FaultInjector:
    """Seeded between-tick fault injector over a ``ContinuousEngine``::

        inj = FaultInjector(engine, seed=0)
        rec = inj.inject("nan_tile")   # or inject() for a seeded mix
        engine.step()                  # the sentinels flag it in this tick

    ``inject`` returns None when no target exists yet (no live slot with
    committed KV); records accumulate in ``self.records``.  ``leaves``
    narrows the arena leaves a tile fault draws from (("v",) poisons V
    tiles only); the draw still takes its place in the seeded sequence."""

    KINDS = ("nan_tile", "inf_tile", "scale", "table", "bit_flip", "device_loss")

    def __init__(self, engine, seed: int = 0, kinds: Optional[tuple] = None,
                 leaves: Optional[tuple] = None):
        self.engine = engine
        self.rng = np.random.default_rng(seed)
        self.kinds = tuple(kinds) if kinds else self.KINDS
        for k in self.kinds:
            if k not in self.KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.leaves = None if leaves is None else tuple(leaves)
        self.records: list[FaultRecord] = []

    # ------------------------------------------------------------- targets --
    def _live_slots(self) -> list[int]:
        """Live slots whose chains hold at least one committed block."""
        eng = self.engine
        return [s for s, st in enumerate(eng._slots)
                if st is not None and int(eng.pool.positions[s]) > 0 and eng.pool.chain_of(s)]

    def _pick_block(self, slot: int) -> int:
        """A block inside the slot's attended horizon (blocks past it are
        never read, so a fault there could not be seen)."""
        pool = self.engine.pool
        chain = pool.chain_of(slot)
        n = max(1, min(len(chain), pool.blocks_for(int(pool.positions[slot]))))
        return int(chain[self.rng.integers(n)])

    def _arena_names(self, want_scale: bool) -> list:
        return [k for k in sorted(self.engine.pool.caches[0])
                if k.endswith("_scale") == want_scale
                and (want_scale or self.leaves is None or k in self.leaves)]

    def _tile(self, name: str, block: int):
        """(the leaf of ``block``'s device, the block's local id there)."""
        pool = self.engine.pool
        d, local = pool.shard_of_block(block)
        return pool.caches[d][name], local

    # ----------------------------------------------------------- injection --
    def inject(self, kind: Optional[str] = None) -> Optional[FaultRecord]:
        """Inject one fault (``kind`` defaults to a seeded draw from the
        configured mix); the record, or None without a target."""
        if kind is None:
            kind = self.kinds[self.rng.integers(len(self.kinds))]
        rec = getattr(self, f"_inject_{kind}")()
        if rec is not None:
            self.records.append(rec)
        return rec

    def _poison_tile(self, kind: str, value: float) -> Optional[FaultRecord]:
        eng = self.engine
        slots = self._live_slots()
        if not slots:
            return None
        names = self._arena_names(want_scale=False)
        name = names[self.rng.integers(len(names))]
        dtype = eng.pool.caches[0][name].dtype
        if not dtype.is_floating_point:
            raise ValueError(f"{kind} targets fp arenas; the {dtype} arena cannot "
                             "encode nonfinite payloads: use 'scale' against int8")
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        leaf, local = self._tile(name, block)
        layer = int(self.rng.integers(leaf.shape[0]))
        leaf[layer, local].fill_(value)
        return FaultRecord(kind=kind, step=eng.step_count, slot=slot, block=block, layer=layer,
                           leaf=name, value=kind[:3])

    def _inject_nan_tile(self) -> Optional[FaultRecord]:
        return self._poison_tile("nan_tile", float("nan"))

    def _inject_inf_tile(self) -> Optional[FaultRecord]:
        return self._poison_tile("inf_tile", float("inf"))

    def _inject_scale(self) -> Optional[FaultRecord]:
        eng = self.engine
        slots = self._live_slots()
        names = self._arena_names(want_scale=True)
        if not slots or not names:
            return None  # an fp pool has no scales
        name = names[self.rng.integers(len(names))]
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        leaf, local = self._tile(name, block)
        layer = int(self.rng.integers(leaf.shape[0]))
        vals = (np.nan, np.inf, -1.0, 1e6)
        v = vals[self.rng.integers(len(vals))]
        leaf[layer, local].fill_(v)
        return FaultRecord(kind="scale", step=eng.step_count, slot=slot, block=block,
                           layer=layer, leaf=name, value=str(v))

    def _inject_table(self) -> Optional[FaultRecord]:
        eng = self.engine
        slots = self._live_slots()
        if not slots:
            return None
        slot = int(slots[self.rng.integers(len(slots))])
        pool = eng.pool
        chain = pool.chain_of(slot)
        j = int(self.rng.integers(len(chain)))
        wrong = int((chain[j] + 1 + self.rng.integers(pool.num_blocks - 1)) % pool.num_blocks)
        pool.tables[slot, j] = wrong
        pool.tables_dirty = True
        return FaultRecord(kind="table", step=eng.step_count, slot=slot, block=int(chain[j]),
                           value=str(wrong))

    def _inject_bit_flip(self) -> Optional[FaultRecord]:
        eng = self.engine
        slots = self._live_slots()
        if not slots:
            return None
        names = self._arena_names(want_scale=False)
        name = names[self.rng.integers(len(names))]
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        leaf, local = self._tile(name, block)
        layer = int(self.rng.integers(leaf.shape[0]))
        tile = leaf[layer, local].view(torch.uint8).view(-1)
        i = int(self.rng.integers(tile.shape[0]))
        tile[i:i + 1].bitwise_xor_(1)  # the lowest bit of one byte, in place
        return FaultRecord(kind="bit_flip", step=eng.step_count, slot=slot, block=block,
                           layer=layer, leaf=name, detectable=False)

    def _inject_device_loss(self) -> Optional[FaultRecord]:
        eng = self.engine
        pool = eng.pool
        if eng.num_devices < 2:
            return None
        counts: dict[int, int] = {}
        for s in self._live_slots():
            counts[pool.device_of(s)] = counts.get(pool.device_of(s), 0) + 1
        viable = [d for d, n in counts.items()
                  if n >= eng.device_loss_min_slots and d not in pool._lost_devices]
        if not viable:
            return None
        dev = int(viable[self.rng.integers(len(viable))])
        for name, leaf in sorted(pool.caches[dev].items()):
            if name.endswith("_scale"):
                continue
            if not leaf.is_floating_point():
                raise ValueError("device_loss poisons arenas with NaN; int8 arenas cannot "
                                 "encode it")
            leaf[:, :pool.blocks_per_device].fill_(float("nan"))
        return FaultRecord(kind="device_loss", step=eng.step_count, device=dev, value="nan")
