#!/usr/bin/env python3
"""The reference's Table I rows FP32, FP32+Ours and FP32+Ours(hwsim), run
with the JAX package on the CPU, to stand beside the port's (``python -m
repro_torch.benchmarks.table1_accuracy``, ``chip_smoke.py`` phase 13).

Calls the reference's own ``benchmarks.common.train_tiny`` and
``eval_metrics`` for the three rows, as ``benchmarks/table1_accuracy.py``
does; the hwsim row needs ``jax.experimental.enable_x64``, which this JAX
lacks, so the name is aliased to ``jax.enable_x64`` here.  The checkpoint goes to a temporary directory, not to
the reference's ``experiments/artifacts``.  Prints one JSON line: per row
the perplexity, top-1, their changes in percent against FP32, and the
training's wall seconds.

Usage: PYTHONPATH=src JAX_PLATFORMS=cpu python3 table1_jax.py [--steps 300]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.experimental

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmarks import common  # noqa: E402

ROWS = {"FP32": ("exact", "exact_ln"), "FP32+Ours": ("gn", "gn_ln"),
        "FP32+Ours(hwsim)": ("gn_hwsim", "gn_ln_hwsim")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args(argv)
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    with tempfile.TemporaryDirectory() as tmp:
        common.ART = Path(tmp)
        t0 = time.perf_counter()
        cfg, _, params = common.train_tiny(args.steps)
        seconds = time.perf_counter() - t0
        rows = {k: common.eval_metrics(common.with_impls(cfg, sm, nm), params)
                for k, (sm, nm) in ROWS.items()}
    base = rows["FP32"]
    for m in rows.values():
        m["ppl_delta_%"] = 100.0 * (m["perplexity"] - base["perplexity"]) / base["perplexity"]
        m["acc_delta_%"] = 100.0 * (m["top1_acc"] - base["top1_acc"]) / max(base["top1_acc"],
                                                                           1e-9)
    out = {**rows, "steps": args.steps, "train_seconds": seconds,
           "device": str(jax.devices()[0])}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
