"""Load parameters of the JAX package into the port.

``params_from_numpy`` takes the reference ``Model.init(...)`` pytree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX
side; this module imports no JAX) and returns the port's parameter tree:
the same nested keys (``embed/tok``, stacked ``layers/{ln1,ln2}/gamma``,
``layers/mixer/{wq,wk,wv,wo}``, ``layers/mlp/{wi,wg,wo}``,
``final_norm/gamma``, ``lm_head/w``) as f32 tensors.  Random init cannot
match across ``jax.random`` and ``torch``, so this is how the two packages
share weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import Model


def params_from_numpy(model: Model, tree: dict, device=None) -> dict:
    """Check ``tree`` against ``model.param_specs()`` key for key and shape
    for shape, and convert every leaf to an f32 tensor on ``device``."""
    dev = resolve_device(device)

    def conv(spec, node, path):
        if isinstance(spec, ParamSpec):
            arr = np.asarray(node, dtype=np.float32)
            if arr.shape != tuple(spec.shape):
                raise ValueError(f"{path}: shape {arr.shape}, expected {spec.shape}")
            return torch.from_numpy(arr.copy()).to(dev)
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{path or '/'}: keys {got}, expected {sorted(spec)}")
        return {k: conv(spec[k], node[k], f"{path}/{k}") for k in spec}

    return conv(model.param_specs(), tree, "")
