"""Radix prefix cache: token prefixes -> physical block chains (port of
``repro/serve/prefix_cache.py``).

A physical KV block reads the same through any slot's table: the GN
softmax maps masked scores to numerators of exactly zero with Σp = 1, so
sharing a block changes no result.  This module is the host-side index that
finds the blocks to share; the pool owns refcounts and free lists, and the
copy-on-write fork of a partially matched block.

One radix tree a device, as the reference's: a slot only holds blocks of its
own device's range, so a chain is device-local.  A lookup takes the longest
match over every device's tree (ties to the lowest device) and names its
device (``PrefixHit.device``), to which admission pulls the request.

Each tree node keys one block-aligned chunk of ``block_size`` tokens (the
raw int32 bytes) and holds the physical block whose KV covers those tokens
at those positions.  A node may also hold one partial tail: the sub-block
remainder of the latest finished prompt under it, which lets admission
share past the last full block (the engine forks that block before the new
request writes into it).

Only immutable prompt KV is indexed: full prompt blocks when their owner
finishes prefilling, the partial prompt tail when the owner finishes (its
decode writes land past every sharer's causal mask).  Generated-token KV is
never indexed, so greedy tokens equal the unshared run's by construction.

The cache holds one reference per indexed block; under block pressure the
pool reclaims cache-only blocks (refcount 1) through ``evict_lru``: partial
tails and childless nodes first, least recently used by a deterministic op
counter (never wall time), and when only interior nodes whose descendants
live slots pin are left, the deepest LRU one's whole subtree is cut.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PrefixHit:
    """One admission-time lookup: ``blocks`` are the fully matched chain
    blocks (``shared_len // block_size`` of them) the slot attaches read-only;
    ``tail_src`` is the block holding the partially matched remainder, which
    the pool forks into a private block (None when the match ends on a block
    boundary).  ``device`` is the device whose tree matched: its range holds
    every block of the hit."""

    device: int
    blocks: list[int]
    shared_len: int
    tail_src: Optional[int] = None


class _Node:
    __slots__ = ("block", "children", "tail", "stamp")

    def __init__(self, block: Optional[int]):
        self.block = block  # physical id; None only at the root
        self.children: dict[bytes, _Node] = {}
        # (tail token bytes, token count, physical block), at most one
        self.tail: Optional[tuple[bytes, int, int]] = None
        self.stamp = 0


class PrefixCache:
    def __init__(self, block_size: int, num_devices: int = 1):
        self.block_size = int(block_size)
        self.num_devices = int(num_devices)
        self.pool = None  # bound by BlockPagedKVPool.attach_prefix_cache
        self.clear()

    def clear(self) -> None:
        self._roots = [_Node(None) for _ in range(self.num_devices)]
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _iter_nodes(self, device: int):
        stack = [self._roots[device]]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def cached_blocks(self, device: Optional[int] = None) -> int:
        """Blocks the index holds a reference to (on ``device``, or all)."""
        devs = range(self.num_devices) if device is None else (device,)
        return sum((node.block is not None) + (node.tail is not None)
                   for d in devs for node in self._iter_nodes(d))

    def evictable_count(self, device: int, refcounts: np.ndarray) -> int:
        """Indexed blocks on ``device`` no live slot references (refcount 1:
        the cache's own): what block pressure can reclaim there.  Exact
        because ``evict_lru`` falls back to cutting a pinned subtree, so
        every counted block can be reached."""
        n = 0
        for node in self._iter_nodes(device):
            if node.block is not None and refcounts[node.block] == 1:
                n += 1
            if node.tail is not None and refcounts[node.tail[2]] == 1:
                n += 1
        return n

    def _chunks(self, tokens: np.ndarray, limit: int):
        bs = self.block_size
        for i in range(limit // bs):
            yield tokens[i * bs:(i + 1) * bs].tobytes()

    def match_len(self, tokens) -> int:
        """Longest indexed prefix of ``tokens``, touching no LRU stamp or
        counter (the scheduler's submit-time hint)."""
        hit = self.lookup(tokens, touch=False)
        return hit.shared_len if hit else 0

    def lookup(self, tokens, cap: Optional[int] = None,
               touch: bool = True) -> Optional[PrefixHit]:
        """Longest matched prefix of ``tokens`` over every device's tree (ties
        to the lowest device), at most ``cap`` tokens (the engine passes
        prompt_len - 1, so the last prompt token always runs through prefill
        and the first sampled token comes from its logits)."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        limit = tokens.shape[0] if cap is None else min(cap, tokens.shape[0])
        if limit <= 0:
            self.misses += touch
            return None
        best, best_path = None, []
        for d in range(self.num_devices):
            hit, path = self._match(d, tokens, limit)
            if hit is not None and (best is None or hit.shared_len > best.shared_len):
                best, best_path = hit, path
        if best is None:
            self.misses += touch
            return None
        if touch:
            self.hits += 1
            stamp = self._tick()
            for n in best_path:
                n.stamp = stamp
        return best

    def _match(self, device: int, tokens: np.ndarray, limit: int) -> tuple:
        """(the hit on ``device``'s tree or None, the nodes it walked)."""
        bs = self.block_size
        node, path = self._roots[device], []
        for key in self._chunks(tokens, limit):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            path.append(node)
        shared = len(path) * bs
        tail_src = None
        if shared < limit:
            # past the full-block walk, the node's partial tail and any
            # partially matching full-block child both offer a fork source:
            # the longest token run wins (ties: the tail, then the first
            # child inserted)
            nxt = tokens[shared:min(shared + bs, limit)]
            extra, src, src_node = 0, None, None
            if node.tail is not None:
                ttok, tlen, tblock = node.tail
                want = np.frombuffer(ttok, np.int32)
                n = min(tlen, nxt.shape[0])
                run = int(np.cumprod(nxt[:n] == want[:n]).sum()) if n else 0
                if run > extra:
                    extra, src = run, tblock
            for ckey, child in node.children.items():
                have = np.frombuffer(ckey, np.int32)[:nxt.shape[0]]
                run = int(np.cumprod(nxt == have).sum()) if nxt.size else 0
                if run > extra:
                    extra, src, src_node = run, child.block, child
            if extra:
                shared += extra
                tail_src = src
                if src_node is not None:
                    # stamped with the path, so the fork source is not the
                    # next eviction
                    path.append(src_node)
        if not shared:
            return None, path
        return PrefixHit(device=device, blocks=[n.block for n in path[:shared // bs]],
                         shared_len=shared, tail_src=tail_src), path

    def insert(self, tokens, blocks: list[int], device: int = 0) -> None:
        """Index ``tokens`` (a prefilled prompt prefix) backed by the chain
        ``blocks`` (``ceil(len(tokens) / block_size)`` entries) of
        ``device``'s range, in that device's tree.  Existing
        nodes stay (their block holds the same KV: same tokens at the same
        positions through the same tick), so only new nodes take a cache
        reference.  A sub-block remainder becomes the node's one partial
        tail, replacing (and releasing) an earlier one."""
        if self.pool is None:
            raise RuntimeError("PrefixCache is not attached to a pool")
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
        bs = self.block_size
        full, rem = divmod(tokens.shape[0], bs)
        node = self._roots[device]
        stamp = self._tick()
        for i, key in enumerate(self._chunks(tokens, full * bs)):
            child = node.children.get(key)
            if child is None:
                child = node.children[key] = _Node(blocks[i])
                self.pool.cache_ref(blocks[i])
                self.inserts += 1
            child.stamp = stamp
            node = child
        if rem:
            tail_block = blocks[full]
            old = node.tail
            if old is not None and old[2] == tail_block and old[1] >= rem:
                return  # an equal or longer tail of the same block stands
            node.tail = (tokens[full * bs:].tobytes(), rem, tail_block)
            self.pool.cache_ref(tail_block)
            self.inserts += 1
            if old is not None:
                self.pool.cache_unref(old[2])

    def evict_lru(self, device: int, refcounts: np.ndarray) -> Optional[int]:
        """Detach and return the least recently used evictable block on
        ``device`` (refcount 1), leaf first: partial tails, then childless tail-less
        nodes.  When none is evictable but refcount-1 interior nodes remain
        (live slots pin their descendants), the deepest LRU one's subtree is
        cut: the descendants' entries are dropped (cache-only ones recycle
        now, pinned ones are indexed again when their owner finishes).
        None when nothing is evictable; the pool drops the returned block's
        reference."""
        best = None  # leaves: ((stamp, kind), holder, key, node)
        cut = None   # fallback: ((stamp, -depth), parent, key, node)
        stack = [(self._roots[device], None, None, 0)]
        while stack:
            node, parent, key, depth = stack.pop()
            if node.tail is not None and refcounts[node.tail[2]] == 1:
                cand = ((node.stamp, 0), node, None, None)
                if best is None or cand[0] < best[0]:
                    best = cand
            if parent is not None and refcounts[node.block] == 1:
                if not node.children and node.tail is None:
                    cand = ((node.stamp, 1), parent, key, node)
                    if best is None or cand[0] < best[0]:
                        best = cand
                else:
                    cand = ((node.stamp, -depth), parent, key, node)
                    if cut is None or cand[0] < cut[0]:
                        cut = cand
            for k, child in node.children.items():
                stack.append((child, node, k, depth + 1))
        kind = 2
        if best is not None:
            (_, kind), holder, key, node = best
        elif cut is not None:
            _, holder, key, node = cut
        else:
            return None
        self.evictions += 1
        if kind == 0:
            block = holder.tail[2]
            holder.tail = None
            return block
        holder.children.pop(key)
        if kind == 2:
            # the cut node's block goes back to the caller; everything below
            # is released here
            if node.tail is not None:
                self.pool.cache_unref(node.tail[2])
                node.tail = None
            stack = list(node.children.values())
            node.children = {}
            while stack:
                sub = stack.pop()
                self.pool.cache_unref(sub.block)
                if sub.tail is not None:
                    self.pool.cache_unref(sub.tail[2])
                stack.extend(sub.children.values())
        return node.block
