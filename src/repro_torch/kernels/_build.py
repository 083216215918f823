"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a``.  All sources build at once,
one ``nvcc`` process each, the first time any kernel is launched; the
libraries land in a git-ignored directory keyed by a hash of the sources
and flags, so a later process reuses them and an edited source rebuilds.
Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
# taken around every wrapper's launch counter: the shards of a lockstep
# serving tick launch from threads of their own at once
COUNT_LOCK = threading.Lock()
# -fmad=false: no a*b+c contraction into an FMA, so the kernels round where
# the reference rounds; -Xptxas -v: registers, shared memory and spills in
# the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None  # wall time of this process's build, if it built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin); "
                           "the CUDA kernels are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns name -> CDLL.

    Raises RuntimeError with nvcc's output when a source fails to compile."""
    global build_seconds
    if _libs:
        return _libs
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [src for src in _sources() if not (out / f"{src.stem}.so").exists()]
    if todo:
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = []
        for src in todo:
            # a private temp name, renamed into place: concurrent builds
            # never load a half-written library
            tmp = out / f"{src.stem}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            (out / f"{src.stem}.log").write_text(log)
            if proc.returncode:
                failed.append(f"--- {src.name} (nvcc exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out / f"{src.stem}.so")
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
    for src in _sources():
        _libs[src.stem] = ctypes.CDLL(str(out / f"{src.stem}.so"))
    return _libs


def build_logs() -> dict[str, str]:
    """nvcc's output (ptxas register/spill report) per source, where built."""
    out = build_dir()
    return {p.stem: p.read_text() for p in sorted(out.glob("*.log"))}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build_all()[name]


def on_device(device: torch.device | None):
    """A context in which ``device`` is the CUDA runtime's current device (a
    device without an index names the current one: nothing to enter)."""
    if device is None or device.index is None:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(device: torch.device, entry, *args) -> int:
    """Call the C ``entry`` with ``device``, the device of the tensors it
    takes, current: a launch, and the ``cudaFuncSetAttribute`` before it,
    apply to the runtime's current device, not to the device of the
    pointers or of the stream passed in, so a shard's tensors on ``cuda:1``
    launched while ``cuda:0`` is current would go to the wrong card.  Every
    ctypes entry of the kernels' wrappers is called through here."""
    with on_device(device):
        return entry(*args)


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` has no memory to launch on: a meta tensor, or a fake one
    (``torch._subclasses.FakeTensor``, the multi-pod dry run's).  A wrapper
    given one returns outputs of its call's shapes and dtypes and launches
    nothing; a real CPU tensor still takes the plain version and a real
    CUDA tensor the kernel."""
    if t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def check(rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {torch.cuda.CudaError(rc)}")
