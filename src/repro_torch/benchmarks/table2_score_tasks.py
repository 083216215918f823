"""Table II analogue: score-task degradation of the proposed design against
prior approximations (port of ``benchmarks/table2_score_tasks.py``).

The paper's claim: the unnormalized designs (Softermax [5], quant-approx
[13], SoftmAP [14]) lose 0.49-13.68% on score-oriented tasks, while
guaranteed normalization loses about nothing.  Same protocol as Table I:
each non-GEMM implementation pair is injected into the FP32-trained tiny
backbone (``common.train_tiny``) and its held-out perplexity compared with
FP32's.  The GN row runs the port's CUDA kernels on the card; the baselines
run their plain ``core`` functions, as the reference runs them in jnp.

Usage:
  python -m repro_torch.benchmarks.table2_score_tasks [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.benchmarks.common import eval_metrics, train_tiny, with_impls, writeout

METHODS = {
    # label: (softmax_impl, norm_impl), norm baselines paired as in the refs
    "Softermax[5]-style": ("softermax", "exact_ln"),
    "QuantApprox[13]-style": ("log_domain", "integer_ln"),
    "PseudoSoftmax[6]-style": ("pseudo", "exact_ln"),
    "LUT-LN[15]-style": ("exact", "lut_ln"),
    "Proposed(GN)": ("gn", "gn_ln"),
}


def run(steps: int = 300, device=None, root: Path | None = None) -> dict:
    """{row: {perplexity, top1_acc, optimal_perplexity, ppl_drop_%}}, FP32
    first, then METHODS."""
    cfg, _, params, _ = train_tiny(steps, device=device, root=root)
    base = eval_metrics(cfg, params)
    rows = {"FP32": {**base, "ppl_drop_%": 0.0}}
    for label, (sm, nm) in METHODS.items():
        m = eval_metrics(with_impls(cfg, sm, nm), params)
        m["ppl_drop_%"] = 100.0 * (m["perplexity"] - base["perplexity"]) / base["perplexity"]
        rows[label] = m
    return writeout("table2_score_tasks", rows, root)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--outdir", default=None, help="default: runs/table1")
    args = ap.parse_args(argv)
    rows = run(args.steps, args.device, Path(args.outdir) if args.outdir else None)
    print(f"{'method':24s} {'ppl':>9s} {'drop%':>8s} {'top1':>7s}")
    for k, m in rows.items():
        print(f"{k:24s} {m['perplexity']:9.3f} {m['ppl_drop_%']:8.3f} {m['top1_acc']:7.4f}")
    return rows


if __name__ == "__main__":
    main()
