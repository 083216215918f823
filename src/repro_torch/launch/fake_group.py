"""A fake process group: N ranks in this one process (the multi-pod dry
run's counterpart of ``repro/launch/_host_devices.py``, which forces 512
XLA host devices before JAX starts).

``fake_group(world)`` joins this process to a ``world``-rank group of
PyTorch's ``"fake"`` backend (``torch.testing._internal.distributed.
fake_pg``: ``FakeStore``, no peers, no communication; each collective
returns at once with an output of the right shape).  This process is rank 0,
the device whose program the dry run costs; every rank of a production mesh
runs the same program on shards of the same shapes, so rank 0 stands for
each.  ``launch.mesh.make_production_mesh`` builds its (16, 16) or
(2, 16, 16) ``DeviceMesh`` over the group unchanged.  A process holds one
default group at a time, so the group is left when the block ends.
"""
from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[int]:
    """This process as rank 0 of a ``world``-rank fake group for the block;
    yields ``world``.  Raises if the process already belongs to a group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if world < 1:
        raise ValueError(f"a fake group needs at least one rank, got {world}")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group: a fake group "
                           "would replace it")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield world
    finally:
        dist.destroy_process_group()
