"""Plain PyTorch versions of the GN softmax kernel's two entries.

``gn_softmax_ref`` is ``core.gn_softmax``, the float-faithful Algorithm 1
the JAX model runs (``repro/core/gn_softmax.py``; the reference's own kernel
oracle ``repro/kernels/gn_softmax/ref.py`` computes the same entries).
``gn_softmax_scores_ref`` is the chain an attention layer runs around it
(``scores_chain``): the raw score product times the scale in its own dtype,
cast to f32, masked at -1e30, the softmax, cast to the output dtype, as the
reference's ``_sdpa`` and its reads do (``repro/models/attention.py:44-47``).
They are the CPU path of ``ops`` and the yardsticks the CUDA kernel is held
against on the card.  ``cuda_calls`` counts calls on CUDA tensors, so a run
can show that its main path never fell back to these versions there.
"""
from __future__ import annotations

import torch

from repro_torch.core.gn_softmax import gn_softmax as core_gn_softmax
from repro_torch.core.luts import SoftmaxLUTConfig, TPU_SOFTMAX_LUT

NEG_INF = -1e30  # a masked score, as the model's
cuda_calls = 0


def gn_softmax_ref(x: torch.Tensor, cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """GN softmax over the last dim; the output has x's dtype."""
    global cuda_calls
    if x.is_cuda:
        cuda_calls += 1
    return core_gn_softmax(x, cfg)


def scores_chain(scores: torch.Tensor, scale: float | None, mask: torch.Tensor | None,
                 out_dtype: torch.dtype, softmax) -> torch.Tensor:
    """``softmax`` over the rows of ``scores * scale`` (the scale rounded to
    the scores' dtype first, as jnp rounds a Python float, the product in
    that dtype), cast to f32, at -1e30 where ``mask`` (broadcastable) is
    False; the probabilities cast to ``out_dtype``."""
    s = scores if scale is None else scores * torch.tensor(scale, dtype=scores.dtype)
    s = s.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return softmax(s).to(out_dtype)


def gn_softmax_scores_ref(scores: torch.Tensor, scale: float | None = None,
                          mask: torch.Tensor | None = None,
                          out_dtype: torch.dtype | None = None,
                          cfg: SoftmaxLUTConfig = TPU_SOFTMAX_LUT) -> torch.Tensor:
    """The fused entry's plain version: ``scores_chain`` over the GN
    softmax; ``out_dtype`` defaults to the scores'."""
    return scores_chain(scores, scale, mask, out_dtype or scores.dtype,
                        lambda s: gn_softmax_ref(s, cfg))
