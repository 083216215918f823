"""Plain PyTorch version of the GN softmax kernel.

It is ``core.gn_softmax``, the float-faithful Algorithm 1 the JAX model runs
(``repro/core/gn_softmax.py``; the reference's own kernel oracle
``repro/kernels/gn_softmax/ref.py`` computes the same entries): the CPU path
of ``ops`` and the yardstick the CUDA kernel is held against on the card.
``cuda_calls`` counts calls on CUDA tensors, so a run can show that its main
path never fell back to this version there.
"""
from __future__ import annotations

import torch

from repro_torch.core.gn_softmax import gn_softmax as core_gn_softmax
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT

cuda_calls = 0


def gn_softmax_ref(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """GN softmax over the last dim; the output has x's dtype."""
    global cuda_calls
    if x.is_cuda:
        cuda_calls += 1
    return core_gn_softmax(x, cfg)
