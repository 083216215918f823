"""Pick softmax/norm implementations by name, as ``repro/core/api.py``.

Models take ``softmax_impl`` / ``norm_impl`` strings in their config, so
the paper's technique and every baseline are a configuration axis.  The
names are the reference's; any other raises ``KeyError``.  These are the
plain functions: the model layers route ``gn`` and the GN norms through
the CUDA kernels' wrappers (``models/attention.py``, ``models/layers.py``).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import baselines
from repro_torch.core.gn_layernorm import (
    exact_layernorm,
    exact_rmsnorm,
    gn_layernorm,
    gn_layernorm_hwsim,
    gn_rmsnorm,
)
from repro_torch.core.gn_softmax import exact_softmax, gn_softmax, gn_softmax_hwsim


def get_softmax(name: str) -> Callable:
    table = {
        "exact": exact_softmax,
        "gn": gn_softmax,
        "gn_hwsim": gn_softmax_hwsim,
        "softermax": baselines.softermax,
        "pseudo": baselines.pseudo_softmax,
        "log_domain": baselines.log_domain_softmax,
    }
    if name not in table:
        raise KeyError(f"unknown softmax impl {name!r}; have {sorted(table)}")
    return table[name]


def get_norm(name: str) -> Callable:
    """Norm fns with signature (x, gamma=None, beta=None) -> y."""
    table = {
        "exact_ln": exact_layernorm,
        "gn_ln": gn_layernorm,
        "gn_ln_hwsim": gn_layernorm_hwsim,
        "exact_rms": lambda x, gamma=None, beta=None: exact_rmsnorm(x, gamma),
        "gn_rms": lambda x, gamma=None, beta=None: gn_rmsnorm(x, gamma),
        "integer_ln": baselines.integer_layernorm,
        "lut_ln": baselines.lut_layernorm,
        "rmsnorm": lambda x, gamma=None, beta=None: baselines.rmsnorm(x, gamma),
    }
    if name not in table:
        raise KeyError(f"unknown norm impl {name!r}; have {sorted(table)}")
    return table[name]
