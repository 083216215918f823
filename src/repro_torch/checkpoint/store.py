"""Checkpoint store: one npz of arrays and a JSON manifest per step, written
atomically (port of ``repro/checkpoint/store.py``, in its format).

A checkpoint of either package restores in the other: leaves are named by
the reference's flattened paths (dict keys and sequence indices joined by
"/", so a ``(params, opt_state)`` tuple gives ``0/embed/tok``, ``1/m/...``
and ``1/step``), stored under ``step_XXXXXXXX/arrays.npz`` with a
``manifest.json`` of ``step``, ``keys``, ``dtypes`` and ``extra``.  numpy
has no bfloat16, so a bf16 leaf is stored as its raw bits (``uint16``) with
``dtypes`` saying ``"bfloat16"``, as the reference stores its ml_dtypes
leaves; the bits go through torch, never through ml_dtypes.  A save writes
a temporary directory and renames it into place, so a crash mid-save never
leaves a torn step, and stale temporary directories are pruned.

Leaves are saved from any device and restored as tensors on the device of
the matching leaf of ``like`` (``restore``) or on the CPU
(``restore_flat``), in the dtype the manifest names.

Sharded trees (DTensor leaves, ``parallel.sharding``): ``save`` writes the
logical arrays, so every rank of the mesh calls it (each DTensor leaf is
gathered whole, ``full_tensor()``), rank 0 writes, and all wait for the
write; a checkpoint does not know the mesh that saved it.
``restore_sharded`` re-places every leaf onto the mesh and the placements
of the matching DTensor leaf of ``like``, which may differ from the saver's
(the reference's elastic restore), each rank keeping its own chunk.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.parallel.sharding import is_dtensor


def _flatten(tree, prefix: str = "") -> dict:
    """{path name: leaf} in the reference's naming."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(the array stored, the dtype name the manifest records)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has none: its raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, want: str | None, device) -> torch.Tensor:
    """The stored array as a tensor of the manifest's dtype (raw bits viewed back)."""
    if want == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def save(path: str | Path, step: int, tree, extra: dict | None = None) -> Path:
    """Atomically write checkpoint ``step`` under ``path``; returns its
    directory.  A tree with DTensor leaves is written by rank 0 of the
    process group, after every rank has gathered them (every rank calls)."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    flat = _flatten(tree)
    if any(is_dtensor(v) for v in flat.values()):
        import torch.distributed as dist

        flat = {k: v.full_tensor() if is_dtensor(v) else v for k, v in flat.items()}
        if dist.get_rank() == 0:
            _write(path, final, step, flat, extra)
        dist.barrier()
        return final
    _write(path, final, step, flat, extra)
    return final


def _write(path: Path, final: Path, step: int, flat: dict, extra: dict | None) -> None:
    tmp = path / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "dtypes": dtypes, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    for stale in path.glob(".tmp_step_*"):  # from crashed saves
        shutil.rmtree(stale, ignore_errors=True)


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in path.glob("step_*") if p.is_dir())
    return steps[-1] if steps else None


def _load(path: Path, step: int) -> tuple:
    ckpt = path / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    return np.load(ckpt / "arrays.npz"), manifest


def restore(path: str | Path, step: int, like) -> tuple:
    """Restore into the structure of ``like`` (a nested dict/tuple/list of
    tensors): (tree, manifest).  Leaves are matched by path name, so a
    ``like`` of ``(params,)`` reads only the ``0/...`` keys of a training
    checkpoint; each comes back on its ``like`` leaf's device."""
    data, manifest = _load(Path(path), step)
    flat_like = _flatten(like)
    missing = set(flat_like) - set(data.files)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    dtypes = manifest.get("dtypes", {})

    def build(tree, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(build(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        device = tree.device if torch.is_tensor(tree) else "cpu"
        return _to_tensor(data[prefix], dtypes.get(prefix), device)

    return build(like), manifest


def restore_sharded(path: str | Path, step: int, like) -> tuple:
    """Elastic restore: (tree, manifest) with every leaf placed as the
    matching leaf of ``like`` is: a DTensor leaf gives the mesh and the
    placements (the reference's ``shardings`` tree), a plain tensor leaf
    stays plain.  The checkpoint may have been written on another mesh: its
    arrays are logical, so this is a pure re-placement, each rank taking its
    chunk of the arrays it reads."""
    tree, manifest = restore(path, step, like)
    return _placed_as(tree, like), manifest


def _placed_as(tree, like):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _placed_as(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_placed_as(v, lk) for v, lk in zip(tree, like))
    if not is_dtensor(like):
        return tree
    return distribute_tensor(tree, like.device_mesh, like.placements, src_data_rank=None)


def restore_flat(path: str | Path, step: int) -> tuple[dict, dict]:
    """The checkpoint as its flat ``{path name: CPU tensor}`` dict and the
    manifest, without a ``like`` tree; dtypes decoded as ``restore`` does."""
    data, manifest = _load(Path(path), step)
    dtypes = manifest.get("dtypes", {})
    return {n: _to_tensor(data[n], dtypes.get(n), "cpu") for n in data.files}, manifest
