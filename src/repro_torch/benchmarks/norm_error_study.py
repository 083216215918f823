"""Normalization-error study: the structure of the paper's Fig. 2 and
Fig. 5 (port of ``examples/norm_error_study.py``).

Fig. 5: the distribution of normalization error (|1 - Σp|, |1 - σ|) over
        transformer-scale random rows, GN against exact and the
        unnormalized baselines (the paper: 77.1% of softmax and 100% of
        LayerNorm errors below 0.2e-6 for GN).
Fig. 2: approximation level against normalization error: the bit-accurate
        GN softmax swept over the Δ grid's fractional bits f (a finer grid,
        a bigger LUT), beside Softermax, whose normalization error is its
        approximation.
Serving: the same lens on the port's streamed paged read over fp and
        int8 KV blocks (per-block scales, dequantized per gathered tile):
        with V dequantizing to exactly 1, the read's output is Σp per query
        row, held against the analytic bound (t + 1) · 2^-23.

Usage:
  python -m repro_torch.benchmarks.norm_error_study [--device cpu] [--rows 4096]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.fig5_norm_error import NORMS, SOFTMAXES
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.core import baselines, get_norm, get_softmax
from repro_torch.core.gn_softmax import gn_softmax_hwsim
from repro_torch.core.luts import SoftmaxLUTConfig
from repro_torch.core.metrics import layernorm_norm_error, softmax_norm_error
from repro_torch.models import attention

FRAC_BITS = (0, 1, 2, 3, 4)
SOFTERMAX_BITS = (4, 6, 8, 10)


def paged_int8_read_norm_error(seed=0, n=3, chunk=4, block_size=4, nb=12, kv_dtype="int8",
                               device="cpu") -> tuple[float, float, int]:
    """Normalization error of the streamed paged read with ``kv_dtype``
    ("fp" or "int8") arenas.

    A scrambled block layout; a Gaussian K arena, quantized to int8 with
    per-block scales; a V arena that dequantizes to exactly 1.0 (int8 64,
    scale 1/64, both powers of two), so the read's output is Σp per query
    row and ``|1 - out|`` is the normalization error of the GN softmax over
    the dequantized scores.  The draws are the reference's (numpy, the same
    seed and order).

    Returns ``(measured_max, analytic_bound, t_max)``.  The bound is the
    float datapath's guarantee: one reciprocal rounding plus one f32
    rounding per accumulated numerator, ``(t + 1) · 2^-23`` for a
    ``t``-column valid stream; the masked and stale columns' numerators are
    exactly 0 (LUT saturation), so ``t`` is the valid count."""
    cfg = reduce_config(get_config("internlm2-1.8b"))
    rng = np.random.default_rng(seed)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kv
    max_bt = nb // n
    kf = rng.standard_normal((nb, block_size, kv, dh)).astype(np.float32)
    if kv_dtype == "int8":
        k_scale = np.maximum(np.abs(kf).reshape(nb, -1).max(axis=1), 1e-30) / 127.0
        arena_k = torch.from_numpy(np.clip(np.round(kf / k_scale[:, None, None, None]),
                                           -127, 127).astype(np.int8))
        arena_v = torch.full((nb, block_size, kv, dh), 64, dtype=torch.int8)
        scales = (torch.from_numpy(k_scale.astype(np.float32)).to(device),
                  torch.full((nb,), 1.0 / 64.0, device=device))
    else:
        arena_k = torch.from_numpy(kf)
        arena_v = torch.ones((nb, block_size, kv, dh))
        scales = None
    q = torch.from_numpy((rng.standard_normal((n, chunk, kv, g, dh)) * 2.0).astype(np.float32))
    tables = torch.from_numpy(rng.permutation(nb).reshape(n, max_bt).astype(np.int32))
    positions = torch.from_numpy(rng.integers(0, (max_bt - 1) * block_size, size=n))
    rows = positions[:, None] + torch.arange(chunk)[None, :]
    out = attention._paged_read_plain(
        q.reshape(n, chunk, kv * g, dh).to(device), arena_k.to(device), arena_v.to(device),
        tables.to(device), rows.to(device), scales, streamed=True)
    measured = float((1.0 - out.float()).abs().max())
    t_max = int(rows.max()) + 1
    return measured, (t_max + 1) * 2.0 ** -23, t_max


def _summary(err: torch.Tensor) -> dict:
    v = err.detach().double().cpu().numpy()
    return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)), "max": float(v.max()),
            "frac_below_2e-7": float((v < 2e-7).mean())}


def run(device=None, rows: int = 4096, seed: int = 42) -> dict:
    """The study's numbers: Fig. 5 summaries per name, the Fig. 2 sweep,
    the Softermax contrast and the paged reads against their bound.
    X: (rows, 256) attention-logit-scale scores (σ = 5); H: (rows, 1024)
    activations (σ = 6, mean 2), drawn on ``device`` from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, 256, generator=gen, device=dev) * 5.0
    h = torch.randn(rows, 1024, generator=gen, device=dev) * 6.0 + 2.0
    exact = get_softmax("exact")(x)
    out = {
        "softmax": {name: _summary(softmax_norm_error(get_softmax(name)(x)))
                    for name in SOFTMAXES},
        "layernorm": {name: _summary(layernorm_norm_error(get_norm(name)(h)))
                      for name in NORMS},
        "fig2": {},
        "softermax": {},
        "paged": {},
    }
    for f in FRAC_BITS:  # the radix stays the paper's R = 8
        p = gn_softmax_hwsim(x, SoftmaxLUTConfig(frac_bits=f))
        out["fig2"][f] = {"lut_entries": 8 << f,
                          "max_abs_p_err": float((p - exact).abs().max()),
                          "max_norm_err": float(softmax_norm_error(p).max())}
    for bits in SOFTERMAX_BITS:
        out["softermax"][bits] = float(softmax_norm_error(
            baselines.softermax(x, frac_bits=bits)).max())
    for kd in ("fp", "int8"):
        measured, bound, t = paged_int8_read_norm_error(kv_dtype=kd, device=dev)
        out["paged"][kd] = {"measured": measured, "bound": bound, "t": t,
                            "ok": measured <= bound}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    ap.add_argument("--rows", type=int, default=4096)
    args = ap.parse_args(argv)
    out = run(args.device, args.rows)

    def q(s):
        return (f"mean {s['mean']:.3e}  p50 {s['p50']:.3e}  p99 {s['p99']:.3e}  "
                f"max {s['max']:.3e}  <2e-7: {100.0 * s['frac_below_2e-7']:.1f}%")

    print("== Fig. 5 analogue: softmax normalization-error distribution ==")
    for name, s in out["softmax"].items():
        print(f"  {name:<12} {q(s)}")
    print("\n== Fig. 5 analogue: layernorm |1-sigma| distribution ==")
    for name, s in out["layernorm"].items():
        print(f"  {name:<12} {q(s)}")
    print("\n== Fig. 2 analogue: approximation level vs normalization error ==")
    print("  (GN-softmax hwsim, sweeping the fixed-point fractional bits f)")
    for f, r in out["fig2"].items():
        print(f"  f={f} (LUT {r['lut_entries']} entries)  max|p-exact| {r['max_abs_p_err']:.3e}"
              f"   |1-sum p| max {r['max_norm_err']:.3e}")
    print("\n== Softermax contrast: its normalization error IS its approximation ==")
    for bits, e in out["softermax"].items():
        print(f"  softermax frac_bits={bits:<2}  |1-sum p| max {e:.3e}")
    print("\n== Paged serving read: |1-sum p| over int8 KV blocks vs bound ==")
    for kd, r in out["paged"].items():
        print(f"  kv_dtype={kd:<5} t={r['t']:<3} measured {r['measured']:.3e}  "
              f"analytic bound (t+1)*2^-23 = {r['bound']:.3e}  "
              f"{'OK' if r['ok'] else 'VIOLATION'}")
    return out


if __name__ == "__main__":
    main()
