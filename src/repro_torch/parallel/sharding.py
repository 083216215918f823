"""Device placement of the sharded serving pool (port of the serving part
of ``repro/parallel/sharding.py``).

The reference shards its continuous engine's slot pool over a 1-D
``("data",)`` mesh: the cache's slot (batch) axis splits into contiguous
per-device ranges and the weights replicate.  The port has no mesh object:
``make_slot_mesh`` returns the shards' devices, one a shard, in slot-range
order, and the engine builds one shard on each (``serve/engine.py``).
"""
from __future__ import annotations

import torch


def make_slot_mesh(num_devices: int, device=None) -> list[torch.device]:
    """The devices of an ``num_devices``-way slot-sharded engine, shard d on
    the d-th: ``cuda:0 .. cuda:N-1`` (raising when fewer are visible) when
    ``device`` is None, else ``device`` for every shard (N shards of one
    device: the CPU tests' ``"cpu"``, or one card)."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if device is not None:
        return [torch.device(device)] * num_devices
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_devices > visible:
        raise ValueError(
            f"slot mesh wants {num_devices} devices but only {visible} are visible; pass "
            f"device='cuda:0' (or 'cpu') to put all {num_devices} shards on one device")
    return [torch.device("cuda", d) for d in range(num_devices)]

