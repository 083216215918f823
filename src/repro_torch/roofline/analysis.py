"""The roofline of one NVIDIA H100 (the port's counterpart of
``repro/roofline/analysis.py``, which holds a TPU's peaks).

A call's least time on the card is the larger of two terms:

  operations = flops / peak rate of the precision they run at
  memory     = bytes / HBM rate

with each input byte read once and each output byte written once.  The
reference adds a collective term over
its interconnect; on one card it is 0, and it waits for the multi-GPU port.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit.  A card below that limit runs slower under load, so
every share this module states names the card and its power limit
(``card()``), and a card it has no peaks for raises: it never guesses.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12}
# the precision whose peak a tensor of this dtype's arithmetic runs at: bf16
# and fp16 on the tensor cores, f32 on the CUDA cores (the port computes with
# TF32 off)
PRECISION = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "f32",
             torch.int8: "int8"}
# the cards whose peaks the table above holds: the SXM part's name as
# torch.cuda.get_device_name reports it
KNOWN_CARDS = ("NVIDIA H100 80GB HBM3",)


class Work(NamedTuple):
    """A call's work: operations, bytes moved (inputs read once, outputs
    written once), and the precision whose peak its operations run at."""

    flops: float
    bytes: float
    precision: str


class Bound(NamedTuple):
    ms: float
    by: str  # "bytes" or "operations", the larger term


def precision_of(dtype) -> str:
    """The ``PEAK_FLOPS`` key for a torch dtype or a key."""
    if isinstance(dtype, str):
        if dtype not in PEAK_FLOPS:
            raise KeyError(f"no peak for precision {dtype!r}; known: {sorted(PEAK_FLOPS)}")
        return dtype
    if dtype not in PRECISION:
        raise KeyError(f"no peak for dtype {dtype}; known: {list(PRECISION)}")
    return PRECISION[dtype]


def bound(flops: float, nbytes: float, precision) -> Bound:
    """The least time the card could take for ``flops`` operations at
    ``precision`` (a ``PEAK_FLOPS`` key or a torch dtype) and ``nbytes``
    bytes: the larger term, in ms, and which one it is."""
    t_ops = flops / PEAK_FLOPS[precision_of(precision)] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return Bound(t_bytes, "bytes") if t_bytes >= t_ops else Bound(t_ops, "operations")


def work_bound(work: Work) -> Bound:
    return bound(work.flops, work.bytes, work.precision)


class Card(NamedTuple):
    name: str
    power_limit: str  # as nvidia-smi reports it, e.g. "700.00 W"

    def __str__(self) -> str:
        return f"{self.name} at {self.power_limit}"


def card(index: int = 0) -> Card:
    """The card these peaks describe: its name and nvidia-smi's power limit.
    Raises on a card whose peaks this module does not hold."""
    name = torch.cuda.get_device_name(index)
    if name not in KNOWN_CARDS:
        raise RuntimeError(f"no published peaks for {name!r} (known: {KNOWN_CARDS}); "
                           "add its data sheet's rates to repro_torch.roofline.analysis")
    limit = "unknown"
    if shutil.which("nvidia-smi"):
        rows = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.split("\n")
        if index < len(rows) and rows[index].strip():
            limit = rows[index].strip()
    return Card(name, limit)
