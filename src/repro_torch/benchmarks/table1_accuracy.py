"""Table I analogue: FP32 against FP32 + Ours (port of
``benchmarks/table1_accuracy.py``).

The paper's claim: injecting GN-Softmax and GN-LayerNorm into an
FP32-trained model leaves both task families unchanged (GLUE +0.07%, SQuAD
-0.01%, perplexity -0.09%).  Here: the reduced gpt-neo-1.3b trained with
exact ops (``common.train_tiny``), evaluated with the same weights under
(exact, exact_ln), (gn, gn_ln) and the bit-accurate integer datapaths
(gn_hwsim, gn_ln_hwsim): held-out perplexity (score) and top-1 next-token
accuracy (rank) on the synthetic corpus, whose entropy floor is known, and
each row's change against FP32 in percent.  On the card the GN row runs the
port's CUDA kernels (flash attention, norm); the hwsim row runs its integer
datapaths in plain torch, as the reference runs them in jnp.

Usage:
  python -m repro_torch.benchmarks.table1_accuracy [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.benchmarks.common import eval_metrics, train_tiny, with_impls, writeout

ROWS = {"FP32": ("exact", "exact_ln"), "FP32+Ours": ("gn", "gn_ln"),
        "FP32+Ours(hwsim)": ("gn_hwsim", "gn_ln_hwsim")}


def run(steps: int = 300, device=None, root: Path | None = None) -> dict:
    """{row: {perplexity, top1_acc, optimal_perplexity, ppl_delta_%,
    acc_delta_%}}, plus the training's wall seconds under "train_seconds"."""
    cfg, _, params, seconds = train_tiny(steps, device=device, root=root)
    rows = {label: eval_metrics(with_impls(cfg, sm, nm), params)
            for label, (sm, nm) in ROWS.items()}
    base = rows["FP32"]
    for m in rows.values():
        m["ppl_delta_%"] = 100.0 * (m["perplexity"] - base["perplexity"]) / base["perplexity"]
        m["acc_delta_%"] = (100.0 * (m["top1_acc"] - base["top1_acc"])
                            / max(base["top1_acc"], 1e-9))
    return writeout("table1_accuracy", {**rows, "train_seconds": seconds, "steps": steps},
                    root)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--outdir", default=None, help="default: runs/table1")
    args = ap.parse_args(argv)
    out = run(args.steps, args.device, Path(args.outdir) if args.outdir else None)
    print(f"{'impl':18s} {'ppl':>9s} {'dppl%':>9s} {'top1':>8s} {'dacc%':>8s}")
    for label in ROWS:
        m = out[label]
        print(f"{label:18s} {m['perplexity']:9.4f} {m['ppl_delta_%']:9.4f} "
              f"{m['top1_acc']:8.4f} {m['acc_delta_%']:8.4f}")
    print(f"(optimal ppl = {out['FP32']['optimal_perplexity']:.3f}; training "
          f"{out['train_seconds']:.1f}s for {out['steps']} steps)")
    return out


if __name__ == "__main__":
    main()
