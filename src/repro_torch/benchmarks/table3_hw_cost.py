"""Table III analogue: a hardware-cost proxy per non-GEMM implementation
(port of ``benchmarks/table3_hw_cost.py``).

Verilog cannot be synthesized here, so, as the reference does, this reports
the cost measures the computation graph itself gives:

  * an op census over one row of N elements: the port's own function traced
    by ``torch.fx.experimental.proxy_tensor.make_fx`` into aten ops (the
    reference walks the jaxpr), each op counted under its aten name
    (``aten.mul.Tensor`` -> ``mul``) with the reference's prefix scheme:
    ``mul``/``dot`` multipliers, ``div`` dividers, ``exp``/``pow``/``log``
    exponential units, a ``sqrt`` in the name a square-root unit.  The two
    IRs decompose differently (``square`` is ``pow`` in aten; a reciprocal
    is ``reciprocal``, not ``div``), so the counts differ from the
    reference's; whether a divider, an exponential or a square root is
    needed at all (zero or not) is the claim;
  * the LUT bytes a hardware unit would carry (the ROMs);
  * a latency model in cycles (the paper: N for softmax, N+1 for LN);
  * an area proxy: the op counts weighted by 28nm-ish relative gate
    weights (div 20, exp 30, mul 10, add 1, shifts 0.5, a LUT byte 0.05),
    stated as a PROXY, not um^2.

Usage:
  python -m repro_torch.benchmarks.table3_hw_cost [--device cpu] [--outdir DIR]
"""
from __future__ import annotations

import argparse
import collections
from pathlib import Path

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch import resolve_device
from repro_torch.benchmarks.common import writeout
from repro_torch.core import get_norm, get_softmax
from repro_torch.core.luts import PAPER_RSQRT, PAPER_SOFTMAX_LUT, exp_luts, rsqrt_mantissa_lut

N = 128  # elements per row for the census

# ops that map to expensive datapath blocks (the reference's weights)
WEIGHTS = {
    "div": 20.0, "exp": 30.0, "log": 30.0, "pow": 30.0, "rsqrt": 25.0,
    "sqrt": 25.0, "dot_general": 10.0, "mul": 10.0,
    "add": 1.0, "sub": 1.0, "max": 1.0, "min": 1.0, "reduce": 1.0,
    "shift_left": 0.5, "shift_right_logical": 0.5, "shift_right_arithmetic": 0.5,
    "and": 0.5, "or": 0.5, "xor": 0.5,
}
SOFTMAXES = ("exact", "gn", "softermax", "pseudo", "log_domain")
NORMS = ("exact_ln", "gn_ln", "integer_ln", "lut_ln")


def census(fn, *args) -> dict:
    """{aten op name: count} of ``fn`` traced on ``args`` (its defaults
    kept: only ``args`` are traced)."""
    graph = make_fx(lambda *a: fn(*a))(*args).graph
    counts: collections.Counter = collections.Counter()
    for node in graph.nodes:
        if node.op == "call_function":
            counts[getattr(node.target, "_opname", None) or str(node.target)] += 1
    return dict(counts)


def _area_proxy(counts: dict, lut_bytes: int) -> float:
    a = 0.0
    for op, n in counts.items():
        for key, w in WEIGHTS.items():
            if op.startswith(key):
                a += w * n
                break
    return a + 0.05 * lut_bytes


def lut_bytes_for(impl: str) -> int:
    if impl.startswith("gn"):
        if "ln" in impl:
            return len(rsqrt_mantissa_lut(PAPER_RSQRT)) * 2  # 16-bit entries
        c, r = exp_luts(PAPER_SOFTMAX_LUT)
        return (len(c) + len(r)) * 2
    if impl in ("log_domain", "lut_ln"):
        return (1 << 4) * 2
    return 0


def _count(counts: dict, match) -> int:
    return sum(n for op, n in counts.items() if match(op))


def run(device=None, root: Path | None = None) -> dict:
    """{"softmax/<impl>" | "norm/<impl>": {mul_ops, div_ops, exp_ops |
    sqrt_ops, lut_bytes, latency_cycles, area_proxy, ops}} and the paper's
    reported areas under "paper_reference_um2".  The census traces on
    ``device`` (cuda unless the caller says otherwise)."""
    x = torch.linspace(-4, 4, N, device=resolve_device(device))[None, :]
    rows = {}
    for impl in SOFTMAXES:
        counts = census(get_softmax(impl), x)
        lb = lut_bytes_for(impl)
        rows[f"softmax/{impl}"] = {
            "mul_ops": _count(counts, lambda o: o.startswith(("mul", "dot"))),
            "div_ops": _count(counts, lambda o: o.startswith("div")),
            "exp_ops": _count(counts, lambda o: o.startswith(("exp", "pow", "log"))),
            "lut_bytes": lb,
            "latency_cycles": "N",
            "area_proxy": _area_proxy(counts, lb),
            "ops": counts,
        }
    for impl in NORMS:
        counts = census(get_norm(impl), x)
        lb = lut_bytes_for(impl)
        rows[f"norm/{impl}"] = {
            "mul_ops": _count(counts, lambda o: o.startswith(("mul", "dot"))),
            "div_ops": _count(counts, lambda o: o.startswith("div")),
            "sqrt_ops": _count(counts, lambda o: "sqrt" in o),
            "lut_bytes": lb,
            "latency_cycles": "N+1" if impl == "gn_ln" else "N",
            "area_proxy": _area_proxy(counts, lb),
            "ops": counts,
        }
    # the paper's reported areas for context (um^2, Samsung 28nm)
    rows["paper_reference_um2"] = {"softmax": 942, "layernorm": 1199,
                                   "SCIS24_softmax": 2492, "SCIS24_ln": 17388,
                                   "TCASII20_softmax": 10081}
    return writeout("table3_hw_cost", rows, root)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--outdir", default=None, help="default: runs/table1")
    args = ap.parse_args(argv)
    rows = run(args.device, Path(args.outdir) if args.outdir else None)
    print(f"{'unit':22s} {'mul':>5s} {'div':>5s} {'exp/sqrt':>9s} {'LUT_B':>6s} {'area~':>8s}")
    for k, m in rows.items():
        if k == "paper_reference_um2":
            continue
        e = m.get("exp_ops", m.get("sqrt_ops", 0))
        print(f"{k:22s} {m['mul_ops']:5d} {m['div_ops']:5d} {e:9d} "
              f"{m['lut_bytes']:6d} {m['area_proxy']:8.1f}")
    print("paper ref (um^2):", rows["paper_reference_um2"])
    return rows


if __name__ == "__main__":
    main()
