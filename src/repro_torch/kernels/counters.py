"""The kernels' launch counters and their plain versions' CUDA-call counters,
read and reset together.  A run that sets them to 0, drives a path and reads
them shows which kernels the path launched, and that no plain version ran
on a CUDA tensor in their place.

A wrapper's counter ticks when its Python code runs, which for a CUDA graph
is at capture and not at replay.  ``serve/graphs.py`` therefore takes a
``snapshot`` around each capture, removes what the capture and its warm-up
counted, and ``add``s the capture's increments on every replay: the counts
stay the launches the card executed on the path."""
from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.gn_attention import ops as attention_ops
from repro_torch.kernels.gn_attention import ref as attention_ref
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_layernorm import ref as norm_ref
from repro_torch.kernels.gn_paged_attention import ops as paged_ops
from repro_torch.kernels.gn_paged_attention import ref as paged_ref
from repro_torch.kernels.gn_softmax import ops as softmax_ops
from repro_torch.kernels.gn_softmax import ref as softmax_ref

# kernel -> (its wrapper module, the wrapper's launch counter); the paged
# read counts its fp and its int8 mode apart; "gn_rmsnorm" counts every norm
# launch, "gn_rmsnorm_fused" those of the fused add + norm among them
WRAPPERS = {"gn_rmsnorm": (norm_ops, "launches"), "gn_rmsnorm_fused": (norm_ops, "launches_fused"),
            "gn_paged_attention": (paged_ops, "launches"),
            "gn_paged_attention_int8": (paged_ops, "launches_int8"),
            "gn_softmax": (softmax_ops, "launches"), "gn_attention": (attention_ops, "launches")}
PLAIN = {"gn_rmsnorm": norm_ref, "gn_paged_attention": paged_ref,
         "gn_softmax": softmax_ref, "gn_attention": attention_ref}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last ``reset``."""
    return {name: getattr(mod, attr) for name, (mod, attr) in WRAPPERS.items()}


def plain_cuda_calls() -> dict[str, int]:
    """Plain-version calls on CUDA tensors per kernel since the last ``reset``."""
    return {name: mod.cuda_calls for name, mod in PLAIN.items()}


def _all() -> list[tuple[object, str]]:
    """(module, attribute) of every counter, launches first."""
    return list(WRAPPERS.values()) + [(mod, "cuda_calls") for mod in PLAIN.values()]


def snapshot() -> tuple[int, ...]:
    """Every counter's value, in ``_all``'s order."""
    return tuple(getattr(mod, attr) for mod, attr in _all())


def add(delta) -> None:
    """Add ``delta`` (a ``snapshot``-ordered sequence) to the counters."""
    with _build.COUNT_LOCK:
        for (mod, attr), d in zip(_all(), delta, strict=True):
            setattr(mod, attr, getattr(mod, attr) + d)


def reset() -> None:
    for mod, attr in _all():
        setattr(mod, attr, 0)
