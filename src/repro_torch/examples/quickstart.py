"""Quickstart: the paper's technique in a page (port of ``examples/quickstart.py``).

The two Guaranteed-Normalization (GN) non-GEMM blocks of "Hardware-Efficient
Softmax and Layer Normalization with Guaranteed Normalization for Edge
Devices":

  * GN-Softmax: a two-LUT factorized exponential and a fixed-point
    renormalization, so sum(p) = 1;
  * GN-LayerNorm: the CoRN (LOD + Newton) reciprocal square root, so
    sigma = 1;

and the paper's central claim: approximations that look fine by max-abs
error can still carry *normalization error*, which the GN designs remove by
construction.  The inputs are drawn with numpy from a seed (the reference
draws them with ``jax.random``); the port's ops run as plain PyTorch on the
device, the gradient and the model through the GN kernels.  Runs on CUDA unless ``--device``
says otherwise.

Usage:
  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.core.api import get_norm, get_softmax
from repro_torch.core.metrics import layernorm_norm_error, softmax_norm_error
from repro_torch.kernels.gn_softmax.ops import gn_softmax as gn_softmax_op
from repro_torch.models.transformer import make_model

SOFTMAXES = ("exact", "gn", "gn_hwsim", "softermax", "pseudo", "log_domain")
NORMS = ("exact_ln", "gn_ln", "gn_ln_hwsim", "integer_ln", "lut_ln")


def inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Logit-scale score rows (8, 128) and activation rows (8, 1024)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, 128)) * 4.0).astype(np.float32)
    h = (rng.normal(size=(8, 1024)) * 7.0 + 3.0).astype(np.float32)
    return x, h


def softmax_errors(x: torch.Tensor) -> dict[str, tuple[float, float]]:
    """name -> (max |1 - sum(p)|, max |p - exact|) over the rows of x."""
    exact = get_softmax("exact")(x)
    out = {}
    for name in SOFTMAXES:
        p = get_softmax(name)(x)
        out[name] = (float(softmax_norm_error(p).max()), float((p - exact).abs().max()))
    return out


def norm_errors(h: torch.Tensor) -> dict[str, float]:
    """name -> max |1 - sigma| of the normalized rows of h."""
    return {name: float(layernorm_norm_error(get_norm(name)(h)).max()) for name in NORMS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    xn, hn = inputs(args.seed)
    x, h = torch.from_numpy(xn).to(device), torch.from_numpy(hn).to(device)

    print(f"== Softmax: normalization error vs approximation error ({device}) ==")
    sm = softmax_errors(x)
    for name, (nerr, aerr) in sm.items():
        print(f"  {name:<12} |1-sum(p)| = {nerr:.3e}   max|p-exact| = {aerr:.3e}")

    print("\n== LayerNorm: |1 - sigma| of the normalized output ==")
    ln = norm_errors(h)
    for name, err in ln.items():
        print(f"  {name:<12} max|1-sigma| = {err:.3e}")

    print("\n== The GN softmax kernel's wrapper is differentiable (straight-through:")
    print("   the exact Jacobian at the approximated output, so sum(dp) = 0) ==")
    z = x[0].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(gn_softmax_op(z).var(), z)
    print(f"  grad ok, sum over row (should be ~0 by the guarantee): {float(g.sum()):.2e}")

    print("\n== Drop-in inside a model: softmax_impl / norm_impl config axis ==")
    cfg = reduce_config(get_config("internlm2-1.8b"), softmax_impl="gn", norm_impl="gn_rms")
    model = make_model(cfg)
    params = model.prepare(model.init(1, device), device)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 16))
                              .astype(np.int32)).to(device)
    with torch.no_grad():
        logits = model.forward(params, {"tokens": tokens})
    finite = bool(torch.isfinite(logits).all())
    print(f"  {cfg.name}: forward OK, logits {tuple(logits.shape)}, finite={finite}")
    return {"softmax": sm, "norm": ln, "grad_sum": float(g.sum()), "finite": finite}


if __name__ == "__main__":
    main()
