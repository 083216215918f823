"""Plain PyTorch versions of the GN LayerNorm/RMSNorm kernel and of its fused
residual-add entry.

They run ``core.gn_layernorm``'s float-faithful datapath (the function the JAX
model runs): the CPU path of ``ops`` and the yardstick the CUDA kernel is
held against on the card.  ``cuda_calls`` counts calls on CUDA tensors, so a
run can show that its main path never fell back to this version there.
"""
from __future__ import annotations

from repro_torch.core import gn_layernorm as core
from repro_torch.core.luts import PAPER_RSQRT, RsqrtConfig

cuda_calls = 0


def gn_layernorm_ref(x, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                     subtract_mean: bool = True):
    global cuda_calls
    if x.is_cuda:
        cuda_calls += 1
    return core._gn_normalize(x, gamma, beta, cfg, subtract_mean)


def gn_add_layernorm_ref(x, r, gamma=None, beta=None, cfg: RsqrtConfig = PAPER_RSQRT,
                         subtract_mean: bool = True):
    """The fused entry's plain version: (s, norm(s)) with s = x + r."""
    global cuda_calls
    if x.is_cuda:
        cuda_calls += 1
    s = x + r
    return s, core._gn_normalize(s, gamma, beta, cfg, subtract_mean)
