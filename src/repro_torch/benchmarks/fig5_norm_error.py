"""Fig. 5 analogue: the distribution of normalization errors during
evaluation (port of ``benchmarks/fig5_norm_error.py``).

|1 - Σp| over layer 0's attention score rows and |1 - σ| over the
embedded (pre-norm) activation rows of the trained tiny backbone's
held-out batches, per implementation.  The paper: 77.1% of softmax and
100% of LN errors below 0.2e-6 for the proposed design, the baselines
orders of magnitude worse.  Every name runs its plain ``core`` function.

Usage:
  python -m repro_torch.benchmarks.fig5_norm_error [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from repro_torch.benchmarks.common import TINY_DATA, train_tiny, writeout
from repro_torch.core import error_histogram, get_norm, get_softmax, metrics
from repro_torch.data.synthetic import batch_at
from repro_torch.models.rope import apply_rope

SOFTMAXES = ("exact", "gn", "gn_hwsim", "softermax", "pseudo", "log_domain")
NORMS = ("exact_ln", "gn_ln", "gn_ln_hwsim", "integer_ln", "lut_ln")
# the histogram edges every GN row's error stays below on the tiny backbone,
# trained 3 or 300 steps: Σp to the reciprocal's rounding (24 bits in the
# hwsim); σ to the 1e-8 the norm adds to the variance of embedding rows of
# σ ~ 0.03, and in the hwsim to their Q8.8 quantization (a few steps a value)
GN_EDGES = {"softmax": {"gn": 1e-6, "gn_hwsim": 1e-5},
            "layernorm": {"gn_ln": 1e-4, "gn_ln_hwsim": 1e-1}}


def collect_attention_inputs(cfg, params, batches) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer 0's raw attention scores (B·H·S rows of S columns, causal, the
    masked columns at -1e30) and the embedded activations (B·S rows of
    d_model), in f32 on the params' device, for each token batch (B, S).
    Recomputed explicitly from the f32 parameters, as the reference's
    probe forward does."""
    dev = params["embed"]["tok"].device
    lp = {k: v[0] for k, v in params["layers"]["mixer"].items()}
    h, hd = cfg.n_heads, cfg.head_dim
    scores_all, acts_all = [], []
    with torch.no_grad():
        for toks in batches:
            toks = torch.as_tensor(toks, device=dev).long()
            x = params["embed"]["tok"][toks].float()
            b, s, d = x.shape
            acts_all.append(x.reshape(-1, d))
            pos = torch.arange(s, device=dev).expand(b, s)
            q = apply_rope((x @ lp["wq"].float()).reshape(b, s, h, hd), pos, cfg.rope_theta)
            k = apply_rope((x @ lp["wk"].float()).reshape(b, s, h, hd), pos, cfg.rope_theta)
            sc = torch.einsum("bshd,bthd->bhst", q, k) * hd ** -0.5
            mask = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
            scores_all.append(torch.where(mask, sc, -1e30).reshape(-1, s))
    return torch.cat(scores_all), torch.cat(acts_all)


def histograms(scores: torch.Tensor, acts: torch.Tensor) -> dict:
    """{"softmax": {name: error_histogram}, "layernorm": {...}} over the
    rows given, every name of SOFTMAXES and NORMS."""
    out = {"softmax": {}, "layernorm": {}}
    for name in SOFTMAXES:
        out["softmax"][name] = error_histogram(metrics.softmax_norm_error(
            get_softmax(name)(scores)))
    for name in NORMS:
        out["layernorm"][name] = error_histogram(metrics.layernorm_norm_error(
            get_norm(name)(acts)))
    return out


def run(steps: int = 300, device=None, root: Path | None = None, n_batches: int = 2) -> dict:
    cfg, _, params, _ = train_tiny(steps, device=device, root=root)
    batches = [batch_at(TINY_DATA, 20_000 + i)["tokens"] for i in range(n_batches)]
    return writeout("fig5_norm_error", histograms(*collect_attention_inputs(cfg, params, batches)),
                    root)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--outdir", default=None, help="default: runs/table1")
    args = ap.parse_args(argv)
    out = run(args.steps, args.device, Path(args.outdir) if args.outdir else None)
    for fam in ("softmax", "layernorm"):
        print(f"--- {fam} normalization error ---")
        print(f"{'impl':12s} {'mean':>10s} {'max':>10s} {'<2e-7':>7s}")
        for k, h in out[fam].items():
            print(f"{k:12s} {h['mean']:10.2e} {h['max']:10.2e} "
                  f"{100 * h['frac_below_0.2e-6']:6.1f}%")
    return out


if __name__ == "__main__":
    main()
