"""The port's checkpoint store against the JAX package's: one format, so a
checkpoint written by either restores in the other bit for bit (f32, bf16
as raw uint16 bits, int32 leaves, 0-d included); the reference's leaf
names for a (params, opt_state) training checkpoint, restored whole or as
(params,) alone; the atomic write and its pruning; ``latest_step``,
``restore_flat`` and the missing-key refusal.  numpy arrays carry the
leaves between the packages; ml_dtypes (for the JAX side's bf16) is
imported by the reference only."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.models.transformer import make_model as jax_make_model
from repro.train import optimizer as jax_opt
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.transformer import make_model
from repro_torch.train import optimizer as t_opt


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 6, generator=g),
            "h": {"bf": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                  "i": torch.arange(7, dtype=torch.int32) * 3 - 5},
            "step": torch.tensor(11, dtype=torch.int32)}


def _jax_like(tree):
    return jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), {
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.int32: jnp.int32}[t.dtype]), tree)


def _bits(x) -> np.ndarray:
    """Raw bytes of a leaf of either package."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy().ravel() if x.dim() else (
            x.reshape(1).view(torch.uint8).numpy())
    a = np.asarray(x)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    tree = _mixed_tree()
    store.save(tmp_path, 5, (tree,), extra={"arch": "x"})
    got, man = jax_store.restore(tmp_path, 5, (_jax_like(tree),))
    assert man["step"] == 5 and man["extra"] == {"arch": "x"}
    assert man["dtypes"] == {"0/w": "float32", "0/h/bf": "bfloat16", "0/h/i": "int32",
                             "0/step": "int32"}
    assert man["keys"] == sorted(man["dtypes"])
    for name, a, b in (("w", got[0]["w"], tree["w"]), ("bf", got[0]["h"]["bf"], tree["h"]["bf"]),
                       ("i", got[0]["h"]["i"], tree["h"]["i"]),
                       ("step", got[0]["step"], tree["step"])):
        assert np.asarray(a).shape == tuple(b.shape), name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert str(np.asarray(got[0]["h"]["bf"]).dtype) == "bfloat16"


def test_jax_checkpoint_restores_bitwise_in_port(tmp_path):
    tree = _mixed_tree()
    jtree = jax.tree.map(jnp.asarray, {"w": tree["w"].numpy(), "i": tree["h"]["i"].numpy()})
    jtree["bf"] = jnp.asarray(tree["h"]["bf"].float().numpy()).astype(jnp.bfloat16)
    jtree["step"] = jnp.int32(11)
    jax_store.save(tmp_path, 3, (jtree, jtree))
    like = ({k: torch.zeros(1) for k in jtree},) * 2
    got, man = store.restore(tmp_path, 3, like)
    assert got[0]["bf"].dtype == torch.bfloat16 and got[0]["i"].dtype == torch.int32
    assert got[1]["step"].shape == () and int(got[1]["step"]) == 11
    for k in jtree:
        np.testing.assert_array_equal(_bits(got[0][k]), _bits(jtree[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(got[1][k]), _bits(jtree[k]), err_msg=k)
    flat, _ = store.restore_flat(tmp_path, 3)
    assert sorted(flat) == man["keys"] and torch.equal(flat["0/bf"], got[0]["bf"])


def test_training_checkpoint_names_and_params_only_restore(tmp_path):
    """A reference (params, opt_state) checkpoint of reduced internlm2-1.8b:
    the port restores it whole into its own (params, opt_state) tree by
    the same names, and ``(params,)`` alone reads only the ``0/`` keys."""
    jcfg = jax_reduce_config(jax_get_config("internlm2-1.8b"), dtype="float32")
    jparams = jax_make_model(jcfg).init(jax.random.PRNGKey(0))
    jstate = jax_opt.init_opt_state(jax_opt.OptimizerConfig(), jparams)
    jax_store.save(tmp_path, 7, (jparams, jstate))
    model = make_model(reduce_config(get_config("internlm2-1.8b"), dtype="float32"))
    params = model.init(1, "cpu")
    state = t_opt.init_opt_state(t_opt.OptimizerConfig(), params)
    (rp, rs), man = store.restore(tmp_path, 7, (params, state))
    assert {"0/embed/tok", "0/layers/mixer/wq", "1/m/embed/tok", "1/v/lm_head/w",
            "1/step"} <= set(man["keys"])
    want = params_from_numpy(model, jax.tree.map(np.asarray, jparams), device="cpu")
    for a, b in zip(t_opt.tree_leaves(rp), t_opt.tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(rs["step"]) == 0 and rs["step"].dtype == torch.int32
    (only,), _ = store.restore(tmp_path, 7, (params,))
    assert all(torch.equal(a, b) for a, b in zip(t_opt.tree_leaves(only),
                                                   t_opt.tree_leaves(rp)))
    # and the port's own training checkpoint reads back in JAX by those names
    store.save(tmp_path, 8, (rp, rs))
    (jp2, js2), _ = jax_store.restore(tmp_path, 8, (jparams, jstate))
    for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_atomic_save_prunes_stale_tmp_and_latest_step(tmp_path):
    assert store.latest_step(tmp_path / "none") is None
    stale = tmp_path / ".tmp_step_00000009"
    stale.mkdir(parents=True)
    (stale / "arrays.npz").write_bytes(b"torn")
    store.save(tmp_path, 2, {"a": torch.ones(2)})
    store.save(tmp_path, 10, {"a": torch.zeros(2)})
    assert not stale.exists() and store.latest_step(tmp_path) == 10
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000010"]
    man = json.loads((tmp_path / "step_00000010" / "manifest.json").read_text())
    assert man == {"step": 10, "keys": ["a"], "dtypes": {"a": "float32"}, "extra": {}}
    store.save(tmp_path, 10, {"a": torch.full((2,), 3.0)})  # a step saved again replaces it
    got, _ = store.restore(tmp_path, 10, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.full((2,), 3.0))
    with pytest.raises(ValueError, match="missing keys"):
        store.restore(tmp_path, 10, {"b": torch.zeros(2)})
    flat, _ = store.restore_flat(tmp_path, 10)
    assert torch.equal(flat["a"], torch.full((2,), 3.0))
