"""The ranks of a multi-device run on one host (the port's counterpart of
``repro/launch/_host_devices.py``, which forces XLA host devices before
JAX starts).

PyTorch runs one process a rank.  ``run_ranks(world, fn, args, device)``
starts ``world`` of them with ``torch.multiprocessing.spawn``, joins each
to one process group, calls ``fn(rank, world, *args)`` in each and returns
rank 0's result:
  * on the CPU (``device="cpu"``): the gloo backend, one intra-op thread a
    rank (the ranks share the host's cores);
  * on cards (``device="cuda"``): NCCL, rank r on ``cuda:r``.  NCCL puts no
    two ranks of one communicator on one card, so more ranks than visible
    cards raise.
The ranks meet through a ``FileStore`` in a fresh temporary directory,
never a fixed TCP port, so runs on one host (test workers side by side)
never collide.  Each rank's output is its own; rank 0's result comes back
through a file beside the store.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import torch


def backend_of(device: str) -> str:
    """The process-group backend of a device type: gloo on the CPU, NCCL on cards."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"ranks run on the CPU or on CUDA cards, not {device!r}")
    return "gloo" if kind == "cpu" else "nccl"


def check_ranks(world: int, device: str) -> None:
    """Raise unless ``world`` ranks of ``device``'s type fit on this host."""
    if world < 1:
        raise ValueError(f"a run needs at least one rank, got {world}")
    if backend_of(device) == "nccl":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > visible:
            raise ValueError(
                f"{world} NCCL ranks need {world} cards, and {visible} are visible: NCCL puts "
                "no two ranks of one communicator on one card (run the mesh on the CPU's gloo "
                "ranks with --device cpu, or a smaller mesh)")


def join_group(rank: int, world: int, store_path: str, device: str) -> torch.device:
    """Join this process to the run's process group as ``rank``; returns the
    rank's device (``cuda:rank`` on cards, the CPU otherwise)."""
    import torch.distributed as dist

    backend = backend_of(device)
    if backend == "gloo":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kwargs)
    return dev


def _rank_main(rank: int, world: int, root: str, device: str, fn, args: tuple) -> None:
    import torch.distributed as dist

    join_group(rank, world, os.path.join(root, "store"), device)
    try:
        out = fn(rank, world, *args)
        if rank == 0:
            with open(os.path.join(root, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, args: tuple = (), device: str = "cpu"):
    """``fn(rank, world, *args)`` in ``world`` fresh processes of one process
    group (``fn`` must be importable by name); returns rank 0's result.  A
    rank that raises makes this raise."""
    import torch.multiprocessing as mp

    check_ranks(world, device)
    with tempfile.TemporaryDirectory(prefix="ranks-") as root:
        mp.spawn(_rank_main, args=(world, root, device, fn, args), nprocs=world, join=True)
        with open(os.path.join(root, "result.pkl"), "rb") as f:
            return pickle.load(f)
