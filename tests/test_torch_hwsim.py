"""The port's bit-accurate hwsim datapaths, fixed-point helpers, prior-work
baselines and metrics (``repro_torch.core``) on the CPU against the JAX
package, on shared numpy inputs.

The reference's hwsim and divider run under ``jax.experimental.enable_x64``,
which the installed JAX lacks; this module's tests alias it to
``jax.enable_x64`` while they run (``x64_alias``; the reference is not
edited, and its own tests still see JAX as it is).

Tolerances, with what was measured when they were set:
  * ``gn_softmax_hwsim``, ``gn_layernorm_hwsim``, ``shift_subtract_div``,
    ``lod``, ``QFormat.quantize``, ``exp_luts_int``: bitwise, masked, NaN,
    ±Inf and negative-mean rows included;
  * the baselines, bitwise on exact inputs (every step exact: integer
    scores, integer log2-domain scores whose sum's mantissa index is 0,
    small-integer activations); on random rows (4096 x 128) ``BASELINE_TOL``
    (``core.baselines.PARITY_TOL``, which the chip run holds the card to):
    at most ``budget`` of the rows past ``atol`` (relative to the row's
    largest |output|), every row within ``step`` (one quantization step, or
    a 2x exponent move).  Measured: softermax bitwise on every row; pseudo
    and log_domain within 6e-8 absolute; integer_ln and lut_ln within
    4.8e-7, rmsnorm 7.2e-7 absolute, no step moved;
  * ``softmax_norm_error`` and ``layernorm_norm_error`` within 6e-7 (five
    ulps of 1: f32 sums of 128 terms in another order; measured 3e-7),
    ``error_histogram`` equal on equal inputs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_base
from repro.core import fixedpoint as jax_fxp
from repro.core import luts as jax_luts
from repro.core import metrics as jax_metrics
from repro_torch.core import baselines, fixedpoint, get_norm, get_softmax, luts, metrics

# the modules, not the same-named functions the packages re-export
jax_sm = importlib.import_module("repro.core.gn_softmax")
jax_ln = importlib.import_module("repro.core.gn_layernorm")
t_sm = importlib.import_module("repro_torch.core.gn_softmax")
t_ln = importlib.import_module("repro_torch.core.gn_layernorm")

# name -> (atol relative to the row's max |output|, row budget past it, step)
BASELINE_TOL = baselines.PARITY_TOL
BASELINES = {"softermax": (baselines.softermax, jax_base.softermax),
             "pseudo": (baselines.pseudo_softmax, jax_base.pseudo_softmax),
             "log_domain": (baselines.log_domain_softmax, jax_base.log_domain_softmax),
             "integer_ln": (baselines.integer_layernorm, jax_base.integer_layernorm),
             "lut_ln": (baselines.lut_layernorm, jax_base.lut_layernorm),
             "rmsnorm": (baselines.rmsnorm, jax_base.rmsnorm)}


@pytest.fixture(autouse=True, scope="module")
def x64_alias():
    """The reference's ``jax.experimental.enable_x64``, which the installed
    JAX lacks, aliased to ``jax.enable_x64`` while this module's tests run
    and removed after, so the JAX package's own tests see JAX as it is."""
    had, old = hasattr(jax.experimental, "enable_x64"), getattr(jax.experimental,
                                                                 "enable_x64", None)
    jax.experimental.enable_x64 = jax.enable_x64
    yield
    if had:
        jax.experimental.enable_x64 = old
    else:
        del jax.experimental.enable_x64


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _score_rows(seed=0, shape=(24, 97)):
    """Random scores with the model's masking and every nonfinite case."""
    x = (np.random.default_rng(seed).normal(size=shape) * 5).astype(np.float32)
    x[:, 70:] = -1e30                   # a masked tail, as the model masks
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, 7] = -np.inf
    x[3, [1, 9]] = np.inf
    x[4, :] = -np.inf
    x[5, :] = -1e30                     # a fully masked row
    x[6, [2, 4]] = [np.nan, np.inf]
    x[7, 75] = np.nan                   # a NaN among the masked columns
    x[8, :] = 0.0
    x[9, :70] = np.arange(70) * 0.5     # exact grid points and half-steps
    return x


# ------------------------------------------------------------------ hwsim --
@pytest.mark.parametrize("frac_bits", [0, 1, 2, 3])
def test_gn_softmax_hwsim_bitwise(frac_bits):
    """Bitwise on random, masked (-1e30), NaN and ±Inf rows.  The masked
    columns saturate the grid index (XLA's saturating cast, then the clip),
    so their numerators are exactly 0; PyTorch's undefined cast would have
    given INT_MIN, clipped to 0, full weight."""
    x = _score_rows(frac_bits)
    got = t_sm.gn_softmax_hwsim(torch.from_numpy(x), luts.SoftmaxLUTConfig(frac_bits=frac_bits))
    want = jax_sm.gn_softmax_hwsim(jnp.asarray(x), jax_luts.SoftmaxLUTConfig(frac_bits=frac_bits))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    finite_max = [1, 2] + list(range(10, 24))  # rows whose max is not NaN
    assert (got[finite_max, 70:] == 0).all()
    live = torch.isfinite(torch.from_numpy(x)).all(dim=-1)
    # Σp to the rescale's per-element rounding and the reciprocal's floor
    assert (got[live].double().sum(-1) - 1).abs().max() <= x.shape[-1] * 2.0 ** -23


def test_gn_softmax_hwsim_default_is_the_paper_lut_and_keeps_bf16():
    x = _score_rows(4)[10:]
    got = t_sm.gn_softmax_hwsim(torch.from_numpy(x).bfloat16())
    want = jax_sm.gn_softmax_hwsim(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _norm_rows(seed, shape=(24, 64)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + rng.normal(size=shape[:-1] + (1,)) * 2).astype(np.float32)
    x[0] -= 20.0                        # negative means: floor division
    x[1] = -np.arange(shape[-1]) / 7.0
    x[2] = 0.0                          # var clamps to 1
    x[3, :5] = [200.0, -200.0, 1e9, -1e9, 1e-5]  # Q8.8 saturation, underflow
    return x


@pytest.mark.parametrize("subtract_mean", [True, False], ids=["ln", "rms"])
@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_gn_layernorm_hwsim_bitwise(subtract_mean, affine):
    x = _norm_rows(1)
    assert (x[:2].mean(-1) < 0).all()
    rng = np.random.default_rng(2)
    g, b = (rng.normal(size=(2, 64)).astype(np.float32) if affine else (None, None))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    got = t_ln.gn_layernorm_hwsim(torch.from_numpy(x), t(g), t(b), subtract_mean=subtract_mean)
    want = jax_ln.gn_layernorm_hwsim(jnp.asarray(x), j(g), j(b), subtract_mean=subtract_mean)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_int_rsqrt_q16_bitwise_over_the_variance_range():
    v = np.concatenate([np.arange(1, 4096), 2 ** np.arange(12, 34),
                        np.random.default_rng(3).integers(1, 2 ** 32, 4096)]).astype(np.int64)
    with jax.enable_x64(True):
        want = np.asarray(jax_ln._int_rsqrt_q16(jnp.asarray(v), jax_luts.PAPER_RSQRT))
    got = t_ln._int_rsqrt_q16(torch.from_numpy(v), luts.PAPER_RSQRT).numpy()
    np.testing.assert_array_equal(got, want)


def test_shift_subtract_div_bitwise_on_edge_values():
    numer = np.array([1, 1 << 15, 1 << 15, 3, 12345678, 0, (1 << 46) - 1, 1 << 15, 7],
                     np.int64)
    denom = np.array([1, 1, (1 << 15) + 7, 2 ** 31 - 1, 5, 9, 3, 2 ** 40, 1 << 24], np.int64)
    with jax.enable_x64(True):
        want = np.asarray(jax_fxp.shift_subtract_div(jnp.asarray(numer), jnp.asarray(denom), 24))
        want8 = np.asarray(jax_fxp.shift_subtract_div(jnp.asarray(numer[:5]), jnp.asarray(3), 8))
    got = fixedpoint.shift_subtract_div(torch.from_numpy(numer), torch.from_numpy(denom), 24)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fixedpoint.shift_subtract_div(torch.from_numpy(numer[:5]), 3, 8).numpy(), want8)
    # an int and a tensor: the quotient lives on the tensor's device
    meta = torch.ones(3, dtype=torch.int64, device="meta")
    assert fixedpoint.shift_subtract_div(1 << 15, meta, 24).device == meta.device
    assert fixedpoint.shift_subtract_div(meta, 3, 24).device == meta.device
    small = numer[:7] < (1 << 39)  # where numer << 24 fits: the floor quotient
    assert (got.numpy()[:7][small] == (numer[:7][small] << 24) // denom[:7][small]).all()


def test_lod_bitwise_on_edge_values():
    v = np.array([0, 1, 2, 3, 4, 7, 8, 255, 256, 2 ** 16, 2 ** 30 + 5, 2 ** 31 - 1, -1, -2,
                  -2 ** 31, 12345], np.int32)
    want = np.asarray(jax_fxp.lod(jnp.asarray(v)))
    got = fixedpoint.lod(torch.from_numpy(v))
    assert got.dtype == torch.int32 and got.tolist()[:3] == [0, 0, 1]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist()[-4:-1] == [31, 31, 31]  # negative int32s read as uint32


def test_fixedpoint_formats_quantize_and_float_lod():
    for name in ("DELTA_Q", "LUT_Q", "PROD_Q", "LN_IN_Q", "LN_STD_Q"):
        a, b = getattr(fixedpoint, name), getattr(jax_fxp, name)
        assert (a.total_bits, a.frac_bits, a.signed, a.scale, a.max_int, a.min_int) == (
            b.total_bits, b.frac_bits, b.signed, b.scale, b.max_int, b.min_int)
    assert fixedpoint.RECIP_BITS == jax_fxp.RECIP_BITS
    x = np.array([0.0, 1 / 512, 3 / 512, -3 / 512, 127.99, 200.0, -200.0, np.inf, -np.inf,
                  np.nan, 1e30], np.float32)
    for q in ("LN_IN_Q", "LUT_Q", "DELTA_Q"):
        got = getattr(fixedpoint, q).quantize(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jax_fxp, q).quantize(
            jnp.asarray(x))))
        np.testing.assert_array_equal(getattr(fixedpoint, q).dequantize(got).numpy(),
                                      np.asarray(getattr(jax_fxp, q).dequantize(
                                          jnp.asarray(got.numpy()))))
    y = np.abs(np.random.default_rng(4).normal(size=200)).astype(np.float32) * 1e3 + 1e-30
    np.testing.assert_array_equal(fixedpoint.float_lod(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax_fxp.float_lod(jnp.asarray(y))))
    np.testing.assert_array_equal(
        fixedpoint.float_mantissa_index(torch.from_numpy(y)[::2], 5).numpy(),  # a strided view
        np.asarray(jax_fxp.float_mantissa_index(jnp.asarray(y[::2]), 5)))


@pytest.mark.parametrize("frac_bits", [0, 3])
def test_exp_luts_int_bitwise(frac_bits):
    for a, b in zip(luts.exp_luts_int(luts.SoftmaxLUTConfig(frac_bits=frac_bits)),
                    jax_luts.exp_luts_int(jax_luts.SoftmaxLUTConfig(frac_bits=frac_bits))):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_gn_log_softmax_matches_jax():
    x = _score_rows(5)[8:]
    got = t_sm.gn_log_softmax(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_sm.gn_log_softmax(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.min() >= np.log(np.float32(1e-30))


# -------------------------------------------------------------- baselines --
def _exact_inputs(name):
    """Inputs on which every step of the baseline is exact in f32 in both
    packages: integer scores for softermax; log2-domain integers (x · log2e
    rounds to an integer) with one column at 0 and the rest at -20..-11, so
    the sum's mantissa index is 0 and lse is an integer, for pseudo and
    log_domain; small-integer rows of 64 columns for the norms."""
    rng = np.random.default_rng(7)
    if name == "softermax":
        return rng.integers(-12, 1, size=(256, 64)).astype(np.float32)
    if name in ("pseudo", "log_domain"):
        log2e = np.float32(jax_base.LOG2E)
        ks = np.arange(-20, -10, dtype=np.float32)
        ks = ks[(ks / log2e).astype(np.float32) * log2e == ks]  # those that round back
        k = rng.choice(ks, size=(256, 64)).astype(np.float32)
        k[:, 0] = 0.0
        return (k / log2e).astype(np.float32)
    return rng.integers(-8, 9, size=(256, 64)).astype(np.float32)


@pytest.mark.parametrize("name", [n for n in BASELINES if n != "rmsnorm"])
def test_baseline_bitwise_on_exact_inputs(name):
    mine, ref = BASELINES[name]
    x = _exact_inputs(name)
    np.testing.assert_array_equal(_bits(mine(torch.from_numpy(x)).numpy()),
                                  _bits(ref(jnp.asarray(x))))


def _random_inputs(name):
    rng = np.random.default_rng(8)
    if name in ("softermax", "pseudo", "log_domain"):
        return (rng.normal(size=(4096, 128)) * 5).astype(np.float32)
    return (rng.normal(size=(4096, 128)) * 3 + 1).astype(np.float32)


def baseline_gaps(got, want, tol) -> dict:
    """Per-row largest |got - want| against ``tol`` = (atol relative to the
    row's largest |want|, row budget, step): the share of rows past atol and
    the largest gap relative to the row scale."""
    atol, _, _ = tol
    gap = np.abs(got.astype(np.float64) - want)
    scale = np.maximum(np.abs(want).max(axis=-1), 1e-30)
    rel = gap.max(axis=-1) / scale
    return {"rows_past": float((rel > atol).mean()), "max_rel": float(rel.max())}


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_within_tolerance_on_random_rows(name):
    mine, ref = BASELINES[name]
    x = _random_inputs(name)
    got = mine(torch.from_numpy(x)).numpy()
    want = np.asarray(ref(jnp.asarray(x)))
    tol = BASELINE_TOL[name]
    gaps = baseline_gaps(got, want, tol)
    assert gaps["rows_past"] <= tol[1], gaps
    assert gaps["max_rel"] <= max(tol[0], tol[2]), gaps
    with_affine = name.endswith("ln") or name == "rmsnorm"
    if with_affine:  # gamma and beta follow the reference's order
        g = np.linspace(0.5, 1.5, 128, dtype=np.float32)
        args = (g,) if name == "rmsnorm" else (g, g[::-1].copy())
        got = mine(torch.from_numpy(x[:64]), *map(torch.from_numpy, args)).numpy()
        want = np.asarray(ref(jnp.asarray(x[:64]), *map(jnp.asarray, args)))
        assert baseline_gaps(got, want, tol)["rows_past"] <= tol[1]


def test_baselines_keep_bf16_and_their_names():
    x = torch.from_numpy(_random_inputs("softermax")[:8]).bfloat16()
    for name in ("softermax", "pseudo", "log_domain"):
        assert get_softmax(name)(x).dtype == torch.bfloat16
    for name in ("integer_ln", "lut_ln", "rmsnorm", "gn_ln_hwsim"):
        assert get_norm(name)(x).dtype == torch.bfloat16
    assert get_softmax("softermax") is baselines.softermax
    assert get_norm("integer_ln") is baselines.integer_layernorm


# ---------------------------------------------------------------- metrics --
def test_metrics_and_histogram_equal():
    x = _random_inputs("softermax")[:512]
    for name in ("exact", "gn", "gn_hwsim", "softermax"):
        p = get_softmax(name)(torch.from_numpy(x)).numpy()
        got = metrics.softmax_norm_error(torch.from_numpy(p)).numpy()
        want = np.asarray(jax_metrics.softmax_norm_error(jnp.asarray(p)))
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-7)
        assert metrics.error_histogram(got) == jax_metrics.error_histogram(got)
    h = _random_inputs("integer_ln")[:512]
    for name in ("exact_ln", "gn_ln", "gn_ln_hwsim", "integer_ln", "lut_ln"):
        y = get_norm(name)(torch.from_numpy(h)).numpy()
        got = metrics.layernorm_norm_error(torch.from_numpy(y)).numpy()
        want = np.asarray(jax_metrics.layernorm_norm_error(jnp.asarray(y)))
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-7)
        edges = [0.0, 1e-6, 1e-3, np.inf]
        assert (metrics.error_histogram(torch.from_numpy(got), edges)
                == jax_metrics.error_histogram(got, edges))
