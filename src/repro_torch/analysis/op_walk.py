"""Pass A's op recorder: one eager call of an entry point, op by op (the
port's counterpart of ``repro/analysis/jaxpr_walk.py``).

The reference walks the jaxpr of a jitted tick.  The port has no traced
program: a tick is Python that dispatches aten ops eagerly, or a CUDA graph
captured from such a call.  ``OpRecorder`` is a ``TorchDispatchMode``: under
it, every aten op of one eager call is recorded with its name, the dtype,
shape and device of each input and output, and each one's storage identity
(``untyped_storage().data_ptr()``, so a view of an arena counts as the
arena).  Record an eager call, never a capture: the recorder refuses to
start while the current stream captures, and a graph's replays dispatch
nothing.

The hand-written kernels are launched through ctypes and never reach the
dispatcher.  Each kernel wrapper is decorated with ``opaque``: under a
recorder, the wrapper's call becomes one record (the kernel's name, its
tensor arguments and results, and its ``work()``), and whatever its body
dispatches (the plain version on the CPU, the output allocations on the
card) is dropped from the walk, as the reference's ``OPAQUE_PRIMITIVES``
keeps a ``pallas_call`` body out of its walk.  Without a recorder the
decorator costs one list test a call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the recorders whose mode is active, innermost last (``opaque`` reads it)
_ACTIVE: list["OpRecorder"] = []


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What the walk keeps of one tensor: no data, no reference."""

    shape: tuple
    dtype: torch.dtype
    device: str      # the device type: "cpu" or "cuda"
    storage: int     # untyped_storage().data_ptr(); 0 for a tensor with no storage
    elems: int       # distinct elements addressed (a stride-0 dim counted once)

    @property
    def nbytes(self) -> int:
        return self.elems * self.dtype.itemsize


@dataclasses.dataclass
class OpRecord:
    """One aten op, or one hand-written kernel's call (``opaque``)."""

    name: str                    # "aten.mm", "aten.index", ... or the kernel's name
    inputs: list[TensorInfo]
    outputs: list[TensorInfo]
    opaque: bool = False
    matmul_flops: float = 0.0    # torch.utils.flop_counter's count, for the ops it knows
    work: Optional[object] = None  # the kernel's ``Work`` (flops, bytes, precision)


def tensor_info(t: torch.Tensor) -> TensorInfo:
    elems = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            elems *= size
    if t.numel() == 0:
        elems = 0
    try:
        storage = t.untyped_storage().data_ptr() if t.numel() and not _shape_only(t) else 0
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        storage = 0
    return TensorInfo(tuple(t.shape), t.dtype, t.device.type, storage, elems)


def _shape_only(t: torch.Tensor) -> bool:
    """A meta or fake tensor: shapes without memory, and so no storage address."""
    if t.is_meta:
        return True
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active.

    ``keep_alive`` holds each output's storage until the recorder is
    dropped, so that no later tensor can reuse a freed address and alias
    an earlier one in the storage dataflow (the audit needs that; costing
    does not, and at full width it would hold every temporary).
    ``opaque_kernels=False`` records what the kernel wrappers dispatch
    instead of one record a call (it shows what their records hide)."""

    def __init__(self, keep_alive: bool = True, opaque_kernels: bool = True):
        super().__init__()
        self.records: list[OpRecord] = []
        self.keep_alive = keep_alive
        self.opaque_kernels = opaque_kernels
        self._kept: list = []
        self._suppress = 0

    def __enter__(self):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("OpRecorder must not run during a CUDA graph capture: "
                               "record the eager call instead")
        if self.opaque_kernels:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.note(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def listening(self) -> Iterator["OpRecorder"]:
        """Take the kernel wrappers' opaque records without entering the
        dispatch mode: for a caller that hands this recorder its ops itself
        through ``note`` (the multi-pod dry run's fake-tensor mode)."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.remove(self)

    def note(self, func, args, kwargs, out) -> None:
        """Record one dispatched op ``func(*args, **kwargs) -> out``."""
        if self._suppress:
            return
        packet = func.overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if self.keep_alive:
            self._kept.extend(t.untyped_storage() for t in outs if t.numel())
        ins = [tensor_info(t) for t in _tensors((args, kwargs))]
        self.records.append(OpRecord(str(packet), ins, [tensor_info(t) for t in outs],
                                     matmul_flops=flops))

    @contextlib.contextmanager
    def suppressed(self) -> Iterator[None]:
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    def add_opaque(self, name: str, args, out, work) -> None:
        outs = _tensors(out)
        if self.keep_alive:
            self._kept.extend(t.untyped_storage() for t in outs if t.numel())
        self.records.append(OpRecord(name, [tensor_info(t) for t in _tensors(args)],
                                     [tensor_info(t) for t in outs], opaque=True, work=work))


def opaque(name, work: Callable | None = None):
    """Decorate a kernel wrapper: under an active ``OpRecorder`` its call is
    one opaque record named ``name`` (a string, or a function of the call's
    arguments) carrying ``work(*args, **kwargs)``, and what its body
    dispatches is dropped.  Nested wrappers inside a recorded one add
    nothing."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = _ACTIVE[-1] if _ACTIVE else None
            if rec is None or rec._suppress:
                return fn(*args, **kwargs)
            with rec.suppressed():
                out = fn(*args, **kwargs)
                cost = work(*args, **kwargs) if work is not None else None
            label = name(*args, **kwargs) if callable(name) else name
            rec.add_opaque(label, (args, kwargs), out, cost)
            return out
        return wrapped
    return deco


def record(fn: Callable, *, keep_alive: bool = True) -> tuple[object, list[OpRecord]]:
    """(fn(), the records of its one eager call)."""
    with torch.no_grad(), OpRecorder(keep_alive=keep_alive) as rec:
        out = fn()
    return out, rec.records


def writers(records: list[OpRecord]) -> dict[int, list[OpRecord]]:
    """Storage -> the records that produced or wrote it."""
    out: dict[int, list[OpRecord]] = {}
    for r in records:
        for t in r.outputs:
            if t.storage:
                out.setdefault(t.storage, []).append(r)
    return out


def reaches(records: list[OpRecord], targets: set[int], sources: set[int]) -> bool:
    """Whether any storage of ``sources`` flows, through the recorded ops'
    inputs and outputs, into a storage of ``targets``."""
    by_storage = writers(records)
    stack, seen = [s for s in targets if s], set()
    while stack:
        s = stack.pop()
        if s in sources:
            return True
        if s in seen:
            continue
        seen.add(s)
        for r in by_storage.get(s, ()):
            stack.extend(t.storage for t in r.inputs if t.storage and t.storage not in seen)
    return False
