"""Deterministic fault injection for the block-paged serving engine (port of
``repro/serve/faults.py``).

The injector corrupts engine state between ticks.  Arena and scale faults
are written in place on the device, into the pool's own tensors, so the
tick's captured graphs read them on their next replay; no host copy of an
arena is made.  Targets are drawn from ``np.random.default_rng(seed)`` in
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
    A whole device's block range; the engine serves one device, so there is
    no device to lose and the injection returns None, as the reference's
    does on one device.
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

    def _arena_items(self, want_scale: bool) -> list:
        return [(k, v) for k, v in sorted(self.engine.pool.cache.items())
                if k.endswith("_scale") == want_scale
                and (want_scale or self.leaves is None or k in self.leaves)]

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
        items = self._arena_items(want_scale=False)
        name, leaf = items[self.rng.integers(len(items))]
        if not leaf.is_floating_point():
            raise ValueError(f"{kind} targets fp arenas; the {leaf.dtype} arena cannot "
                             "encode nonfinite payloads: use 'scale' against int8")
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        layer = int(self.rng.integers(leaf.shape[0]))
        leaf[layer, block].fill_(value)
        return FaultRecord(kind=kind, step=eng.step_count, slot=slot, block=block, layer=layer,
                           leaf=name, value=kind[:3])

    def _inject_nan_tile(self) -> Optional[FaultRecord]:
        return self._poison_tile("nan_tile", float("nan"))

    def _inject_inf_tile(self) -> Optional[FaultRecord]:
        return self._poison_tile("inf_tile", float("inf"))

    def _inject_scale(self) -> Optional[FaultRecord]:
        eng = self.engine
        slots = self._live_slots()
        items = self._arena_items(want_scale=True)
        if not slots or not items:
            return None  # an fp pool has no scales
        name, leaf = items[self.rng.integers(len(items))]
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        layer = int(self.rng.integers(leaf.shape[0]))
        vals = (np.nan, np.inf, -1.0, 1e6)
        v = vals[self.rng.integers(len(vals))]
        leaf[layer, block].fill_(v)
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
        items = self._arena_items(want_scale=False)
        name, leaf = items[self.rng.integers(len(items))]
        slot = int(slots[self.rng.integers(len(slots))])
        block = self._pick_block(slot)
        layer = int(self.rng.integers(leaf.shape[0]))
        tile = leaf[layer, block].view(torch.uint8).view(-1)
        i = int(self.rng.integers(tile.shape[0]))
        tile[i:i + 1].bitwise_xor_(1)  # the lowest bit of one byte, in place
        return FaultRecord(kind="bit_flip", step=eng.step_count, slot=slot, block=block,
                           layer=layer, leaf=name, detectable=False)

    def _inject_device_loss(self) -> Optional[FaultRecord]:
        return None  # one device: nothing to lose
