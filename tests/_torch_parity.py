"""Helpers of the port's serving parity tests (``test_torch_prefix.py``,
``test_torch_sla.py``, ...): reduced internlm2-1.8b (or another arch) at
float32 for both packages (the port's weights converted from the JAX ones),
requests built once and fed to both engines, and a run's summary: greedy
tokens, ``event_log``, ``request_prefix_hits``, completions, the
``metrics()`` keys both engines share, and the final block tables and
refcounts.

A VLM's cross-attention gates are initialised to zero, so an untrained VLM
ignores its patches and a parity test on its init weights would pass with
cross-attention broken: ``pair`` sets every ``xattn_layers/gate`` to
``VLM_GATE`` in the shared tree before either package sees it.
"""
import functools

import jax
import numpy as np

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.data.synthetic import DataConfig, batch_at
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig
from repro_torch.serve.scheduler import Request

ARCH = "internlm2-1.8b"
CHUNK = 4
# metrics the port measures otherwise by design (tests/test_torch_serve.py):
# graph captures and replays stand for compilations and transfer-guarded
# ticks, its read is the kernel (the reference's CPU default is the streamed
# read), and its pool holds a write-sink block
OWN = {"fused_step_compilations", "decode_compilations", "prefill_compilations",
       "transfer_guarded_ticks", "read_path", "kv_hbm_bytes"}
COMPLETION_KEYS = ("request_id", "finish_reason", "arrival_step", "admit_step",
                   "first_token_step", "finish_step", "queue_wait_steps", "ttft_steps",
                   "tpot_steps", "req_class", "preemptions")


# the architectures of the families the port serves: dense, MLA and MoE
FAMILIES = {"dense": ARCH, "mla": "minicpm3-4b", "moe": "llama4-scout-17b-a16e"}
# the cross-attending families (tests/test_torch_xattn.py)
XFAMILIES = {"encdec": "whisper-large-v3", "vlm": "llama-3.2-vision-11b"}
# the sequence-state families, slab only (tests/test_torch_ssm_serve.py)
SFAMILIES = {"ssm": "xlstm-350m", "hybrid": "zamba2-7b"}
VLM_GATE = 0.5


@functools.cache
def pair(arch: str = ARCH):
    """(JAX model, JAX params, the port's model, the port's master weights)
    of ``arch`` reduced at float32, built once a process (callers must not
    write to the weights)."""
    over = {"dtype": "float32"}
    jmodel = jax_make_model(jax_reduce_config(jax_get_config(arch), **over))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if "xattn_layers" in tree:
        tree["xattn_layers"]["gate"] = np.full_like(tree["xattn_layers"]["gate"], VLM_GATE)
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    model = make_model(reduce_config(get_config(arch), **over))
    master = params_from_numpy(model, tree, device="cpu")
    return jmodel, jparams, model, master


def dense():
    """``pair`` of reduced internlm2-1.8b."""
    return pair(ARCH)


def prompt(vocab, length, seed):
    """A prompt from the reference's corpus (the tokens both engines get)."""
    data = DataConfig(vocab=vocab, seq_len=length, global_batch=1, seed=seed)
    return np.asarray(batch_at(data, 0)["tokens"][0], np.int32)


def to_port(reqs):
    """The port's requests with the reference requests' tokens and fields."""
    return [Request(tokens=np.asarray(r.tokens, np.int32), max_new_tokens=r.max_new_tokens,
                    stop_token=r.stop_token, arrival_step=r.arrival_step, id=r.id,
                    req_class=r.req_class, extras=dict(r.extras)) for r in reqs]


def jax_engine(jmodel, jparams, **kw):
    return JaxEngine(jmodel, jparams, cfg=JaxServeConfig(), chunk=CHUNK, **kw)


def port_engine(model, master, **kw):
    return ContinuousEngine(model, master, cfg=ServeConfig(), chunk=CHUNK, device="cpu", **kw)


def set_policy(eng, **policy):
    """Set the JAX engine's SLA policy attributes (``preempt_mode``,
    ``aging_steps``, ``shed_backlog``) and reset it: reset rebuilds its
    scheduler from them, and its compiled ticks, which no policy enters,
    are kept."""
    for key, value in policy.items():
        setattr(eng, key, value)
    eng.reset()
    return eng


def summary(eng, comps) -> dict:
    m = eng.metrics()
    return {
        "tokens": {c.request_id: np.asarray(c.new_tokens).tolist() for c in comps},
        "events": [tuple(int(x) if isinstance(x, (int, np.integer)) else x for x in e)
                   for e in eng.event_log],
        "hits": {int(k): dict(v) for k, v in eng.request_prefix_hits.items()},
        "completions": {c.request_id: {k: getattr(c, k) for k in COMPLETION_KEYS}
                        for c in comps},
        "metrics": m,
        # the block ledger of a paged pool (None over the slab pool)
        "tables": np.array(getattr(eng.pool, "tables", None)),
        "refcounts": np.array(getattr(eng.pool, "refcounts", None)),
        "positions": np.array(eng.pool.positions),
    }


def run(eng, reqs) -> dict:
    return summary(eng, eng.run(reqs))


def assert_same(mine: dict, ref: dict) -> None:
    """Tokens, event log, prefix hits, completions, the shared metrics and
    the final tables and refcounts of two runs' summaries, equal."""
    assert mine["tokens"] == ref["tokens"]
    assert mine["events"] == ref["events"]
    assert mine["hits"] == ref["hits"]
    assert mine["completions"] == ref["completions"]
    shared = sorted((set(mine["metrics"]) & set(ref["metrics"])) - OWN)
    assert {k: mine["metrics"][k] for k in shared} == {k: ref["metrics"][k] for k in shared}
    for key in ("tables", "refcounts", "positions"):
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
