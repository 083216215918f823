"""Normalization-error metrics (paper Sec. II-A, Fig. 5), in PyTorch.

Counterpart of ``repro/core/metrics.py``:

normalization error := |1 - Σp|   (softmax)
                       |1 - σ|    (layernorm output std)
"""
from __future__ import annotations

import numpy as np
import torch


def softmax_norm_error(p: torch.Tensor) -> torch.Tensor:
    """Per-row |1 - Σp| over the last dim."""
    return (1.0 - p.float().sum(dim=-1)).abs()


def layernorm_norm_error(y: torch.Tensor) -> torch.Tensor:
    """Per-row |1 - std(y)| over the last dim (the population std, formed as
    jnp.std forms it), of the output before gamma and beta."""
    y32 = y.float()
    centered = y32 - y32.mean(dim=-1, keepdim=True)
    return (1.0 - centered.square().mean(dim=-1).sqrt()).abs()


def error_histogram(err, edges=None) -> dict:
    """Fig.-5-style distribution summary of normalization errors."""
    if isinstance(err, torch.Tensor):
        err = err.detach().cpu().numpy()
    err = np.asarray(err, dtype=np.float64).ravel()
    if edges is None:
        edges = [0.0, 0.2e-6, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, np.inf]
    counts, _ = np.histogram(err, bins=edges)
    frac = counts / max(err.size, 1)
    return {
        "edges": [float(e) for e in edges],
        "fraction": [float(f) for f in frac],
        "mean": float(err.mean()) if err.size else 0.0,
        "max": float(err.max()) if err.size else 0.0,
        "frac_below_0.2e-6": float((err < 0.2e-6).mean()) if err.size else 0.0,
    }
