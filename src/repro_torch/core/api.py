"""Pick softmax/norm implementations by name, as ``repro/core/api.py``.

Only the names the port implements are here; any other name raises
``KeyError``, as the reference does for names it does not know.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.gn_layernorm import (
    exact_layernorm,
    exact_rmsnorm,
    gn_layernorm,
    gn_rmsnorm,
)
from repro_torch.core.gn_softmax import exact_softmax, gn_softmax


def get_softmax(name: str) -> Callable:
    table = {"exact": exact_softmax, "gn": gn_softmax}
    if name not in table:
        raise KeyError(f"unknown softmax impl {name!r}; have {sorted(table)}")
    return table[name]


def get_norm(name: str) -> Callable:
    """Norm fns with signature (x, gamma=None, beta=None) -> y."""
    table = {
        "exact_ln": exact_layernorm,
        "gn_ln": gn_layernorm,
        "exact_rms": lambda x, gamma=None, beta=None: exact_rmsnorm(x, gamma),
        "gn_rms": lambda x, gamma=None, beta=None: gn_rmsnorm(x, gamma),
    }
    if name not in table:
        raise KeyError(f"unknown norm impl {name!r}; have {sorted(table)}")
    return table[name]
