"""Parity of the port's core GN math (``repro_torch.core``) against the JAX
package on shared numpy inputs: LUTs and grid indices bitwise, the float
datapaths within a few ulps, the guarantees (masked numerators exactly 0,
Σp = 1 to (t+1)·2⁻²³) on the port's own outputs."""
import ast
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as jax_api
from repro.core import luts as jax_luts
from repro_torch.core import get_norm, get_softmax
from repro_torch.core import luts as t_luts

# the modules, not the same-named functions repro.core and repro_torch.core
# re-export
jax_sm = importlib.import_module("repro.core.gn_softmax")
jax_ln = importlib.import_module("repro.core.gn_layernorm")
t_sm = importlib.import_module("repro_torch.core.gn_softmax")
t_ln = importlib.import_module("repro_torch.core.gn_layernorm")

CFG = t_luts.TPU_SOFTMAX_LUT


@pytest.mark.parametrize("frac_bits", [0, 3])
def test_exp_luts_bitwise(frac_bits):
    mine = t_luts.exp_luts(t_luts.SoftmaxLUTConfig(frac_bits=frac_bits))
    ref = jax_luts.exp_luts(jax_luts.SoftmaxLUTConfig(frac_bits=frac_bits))
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_rsqrt_lut_and_inv_sqrt2_bitwise():
    np.testing.assert_array_equal(t_luts.rsqrt_mantissa_lut(t_luts.PAPER_RSQRT),
                                  jax_luts.rsqrt_mantissa_lut(jax_luts.PAPER_RSQRT))
    assert t_luts.INV_SQRT2 == jax_luts.INV_SQRT2
    for name in ("step", "max_delta_int", "residual_entries"):
        assert getattr(CFG, name) == getattr(jax_luts.TPU_SOFTMAX_LUT, name)


def test_factorized_exp_bitwise_on_every_grid_point():
    # all 448 grid points, plus saturation past the coarse LUT's reach
    delta = (np.arange(CFG.max_delta_int + 13) * CFG.step).astype(np.float32)
    mine = t_sm.factorized_exp(torch.from_numpy(delta), CFG).numpy()
    ref = np.asarray(jax_sm._factorized_exp(jnp.asarray(delta), jax_luts.TPU_SOFTMAX_LUT))
    np.testing.assert_array_equal(mine, ref)
    assert (mine[CFG.max_delta_int + 1:] == 0).all()


def _scores(seed, shape=(6, 53), scale=6.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_gn_softmax_indices_bitwise_and_p_within_ulps():
    x = _scores(0)
    x[:, 40:] = -1e30  # a masked tail
    xt = torch.from_numpy(x)
    m = torch.ceil(xt.amax(-1, keepdim=True) / CFG.step) * CFG.step
    mine_idx = t_sm.delta_index((m - xt).clamp_min(0), CFG).numpy()
    mj = jnp.ceil(jnp.max(x, -1, keepdims=True) / CFG.step) * CFG.step
    ref_idx = np.asarray(jnp.clip(jnp.round(jnp.maximum(mj - x, 0) / CFG.step)
                                  .astype(jnp.int32), 0, CFG.max_delta_int))
    np.testing.assert_array_equal(mine_idx, ref_idx)
    p = t_sm.gn_softmax(xt).numpy()
    ref = np.asarray(jax_sm.gn_softmax(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(p, ref, maxulp=4)


@pytest.mark.parametrize("cols", [1, 7, 64, 300])
def test_gn_softmax_guarantees(cols):
    x = _scores(cols, (5, cols))
    cut = max(1, cols // 2)
    x[0, cut:] = -1e30
    p = t_sm.gn_softmax(torch.from_numpy(x)).numpy().astype(np.float64)
    assert (p[0, cut:] == 0).all()  # masked numerators are exactly zero
    assert np.abs(1.0 - p.sum(-1)).max() <= (cols + 1) * 2.0 ** -23


def test_exact_softmax_matches_reference():
    x = _scores(3)
    np.testing.assert_allclose(t_sm.exact_softmax(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_sm.exact_softmax(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_newton_rsqrt_bitwise():
    n = np.concatenate([np.geomspace(1e-8, 1e6, 301), [1.0, 2.0, 0.5, 3.0]]).astype(np.float32)
    mine = t_ln.newton_rsqrt(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jax_ln.newton_rsqrt(jnp.asarray(n))))


def _norm_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64, 256)) * 3 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=256)).astype(np.float32)
    b = (0.1 * rng.normal(size=256)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    return xt, xj, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gn_rms", "gn_ln", "exact_rms", "exact_ln"])
def test_norms_match_reference(kind, dtype):
    """f32: within 1e-6 abs (sum order); bf16: identical after rounding."""
    from repro.core import get_norm as jax_get_norm

    xt, xj, g, b = _norm_inputs(1, dtype)
    beta = "ln" in kind
    mine = get_norm(kind)(xt, torch.from_numpy(g), torch.from_numpy(b) if beta else None)
    ref = (jax_get_norm(kind)(xj, jnp.asarray(g), jnp.asarray(b)) if beta
           else jax_get_norm(kind)(xj, jnp.asarray(g)))
    mine, ref = mine.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(mine, ref)


def test_gn_norm_guarantees_unit_sigma():
    xt, _, _, _ = _norm_inputs(2, "float32")
    y = t_ln.gn_rmsnorm(xt).double()
    assert (y.square().mean(-1) - 1).abs().max().item() < 1e-5
    y = t_ln.gn_layernorm(xt).double()
    assert y.mean(-1).abs().max().item() < 1e-6
    assert (y.square().mean(-1) - 1).abs().max().item() < 1e-5


def test_api_names_and_unknown_names_raise():
    """The port's two name tables are the reference's, name for name, the
    plain ``gn`` and ``exact`` functions among them; any other name raises
    ``KeyError``, as the reference's does."""
    names = {}
    for table in (get_softmax, get_norm, jax_api.get_softmax, jax_api.get_norm):
        with pytest.raises(KeyError) as err:
            table("nope")
        names[table] = ast.literal_eval(str(err.value).split("have ", 1)[1].rstrip("'\""))
    assert names[get_softmax] == names[jax_api.get_softmax]
    assert names[get_norm] == names[jax_api.get_norm]
    assert get_softmax("gn") is t_sm.gn_softmax and get_softmax("exact") is t_sm.exact_softmax
    for name in names[get_softmax]:
        assert callable(get_softmax(name))
    for name in names[get_norm]:
        assert callable(get_norm(name))
