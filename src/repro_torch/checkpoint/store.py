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
(``restore_flat``), in the dtype the manifest names.  ``restore_sharded``
(a multi-device mesh) is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch



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
    """Atomically write checkpoint ``step`` under ``path``; returns its directory."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    tmp = path / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "dtypes": dtypes, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    for stale in path.glob(".tmp_step_*"):  # from crashed saves
        shutil.rmtree(stale, ignore_errors=True)
    return final


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


def restore_flat(path: str | Path, step: int) -> tuple[dict, dict]:
    """The checkpoint as its flat ``{path name: CPU tensor}`` dict and the
    manifest, without a ``like`` tree; dtypes decoded as ``restore`` does."""
    data, manifest = _load(Path(path), step)
    dtypes = manifest.get("dtypes", {})
    return {n: _to_tensor(data[n], dtypes.get(n), "cpu") for n in data.files}, manifest
