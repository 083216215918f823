"""The roofline of one NVIDIA H100 (the port's counterpart of
``repro/roofline/analysis.py``, which holds a TPU's peaks).

A call's least time on the card is the larger of two terms:

  operations = flops / peak rate of the precision they run at
  memory     = bytes / HBM rate

with each input byte read once and each output byte written once.  A step
sharded over a mesh adds the reference's third term (``Roofline``,
``analyze``):

  collective = the bytes each card moves in collectives / LINK_BYTES_PER_S

counted from the c10d functional collectives that DTensor issues
(``op_cost.collective_bytes``, the reference's ring accounting).  Both
production meshes (16 x 16 and 2 x 16 x 16 cards) span more than one
8-card node, and the 16-wide ``model`` axis itself crosses nodes, so the
rate is the slowest link such a mesh crosses: one 400 Gb/s NDR InfiniBand
port a card, 50 GB/s (NVIDIA's DGX H100 layout: eight ConnectX-7 ports,
one a GPU).  NVLink 4 (450 GB/s a direction a card) joins cards only inside
a node.  No run of this repository has measured either rate: on one card
the term is 0.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit.  A card below that limit runs slower under load, so
every share this module states names the card and its power limit
(``card()``), and a card it has no peaks for raises: it never guesses.
"""
from __future__ import annotations

import dataclasses
import shutil
import subprocess
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
# a card's share of the slowest link a production mesh crosses: one 400 Gb/s
# NDR InfiniBand port a card (see the module docstring)
LINK_BYTES_PER_S = 50e9
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


@dataclasses.dataclass
class Roofline:
    """The reference's three-term roofline of one step on ``n_chips``
    cards, per device: ``compute_s`` each precision's recorded operations
    over its peak, ``memory_s`` the recorded (unfused, ``op_cost``) bytes
    over the HBM rate, ``collective_s`` the collective bytes over
    ``LINK_BYTES_PER_S``."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    hlo_flops_total: float  # the reference's name: the recorded operations over every card
    n_chips: int = 256

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / recorded operations: remat and redundancy waste."""
        return self.model_flops / max(self.hlo_flops_total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flop-time over the dominant term."""
        return self.model_flops_per_device_s / max(self.total_s, 1e-30)

    @property
    def model_flops_per_device_s(self) -> float:
        """The model's FLOPs a card at the bf16 peak (the matmuls' precision)."""
        return self.model_flops / self.n_chips / PEAK_FLOPS["bf16"] if self.n_chips else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops": self.model_flops,
            "hlo_flops_total": self.hlo_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }


def analyze(records, n_chips: int, model_flops: float) -> Roofline:
    """The three terms of one device's recorded step (``analysis.op_walk``
    records; rank 0 stands for every rank of a mesh)."""
    from repro_torch.roofline.op_cost import module_cost

    cost = module_cost(records)
    flops = cost.total_flops
    return Roofline(
        compute_s=sum(f / PEAK_FLOPS[p] for p, f in cost.flops.items()),
        memory_s=cost.bytes / HBM_BYTES_PER_S,
        collective_s=cost.collective_total / LINK_BYTES_PER_S,
        flops_per_device=flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_total,
        model_flops=model_flops,
        hlo_flops_total=flops * n_chips,
        n_chips=n_chips,
    )


def model_flops_for(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill fwd-only) / 2·N·B per decode step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one decode step
