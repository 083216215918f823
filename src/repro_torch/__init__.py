"""PyTorch / CUDA port of the GN serving stack, for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package ``repro`` module for module, so every
counterpart is easy to find.  Plain tensor code is PyTorch; the GN paged
attention read and the GN LayerNorm/RMSNorm are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use.  Each kernel's
wrapper runs its plain PyTorch version for CPU tensors and launches the
kernel (or raises) for CUDA tensors.

Entry points take an explicit ``device``: they run on CUDA unless the caller
passes ``device="cpu"``, and raise when no GPU is present and none was given.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.

    Never falls back to the CPU on its own: a caller without a GPU has to
    ask for the CPU explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")
