"""The port's two-shard engine against the JAX engine over two devices.

The JAX ``ContinuousEngine(devices=2)`` needs two JAX devices, which exist
only in a process that started with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` (as
``tests/test_distributed.py`` runs its mesh): a subprocess serves the
reference's five mixed requests (``tests/test_serve_sharded.py``) through
reduced f32 internlm2-1.8b over the paged fp pool (4-token chunks, 8-token
blocks) and prints its tokens, event log, ``device_admits`` and
``metrics()`` as JSON.  The port's
``devices=2`` engine on two shards of the CPU serves the same requests on
the same weights: tokens, the whole event log (slots and devices
included), ``device_admits`` and every shared metric equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np

from repro.serve.scheduler import Request as JaxRequest
from repro_torch.serve.engine import ContinuousEngine, ServeConfig

from _torch_parity import ARCH, CHUNK, OWN, pair, prompt, to_port

ROOT = Path(__file__).resolve().parents[1]
LENS = (5, 9, 14, 22, 7)
BLOCK = 8  # 8-token blocks: three horizon buckets for the subprocess to compile

CHILD = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.configs.registry import get_config, reduce_config
    from repro.data.synthetic import DataConfig, batch_at
    from repro.models.transformer import make_model
    from repro.serve.engine import ContinuousEngine, ServeConfig
    from repro.serve.scheduler import Request
    assert jax.device_count() == 2, jax.devices()
    model = make_model(reduce_config(get_config(sys.argv[1]), dtype="float32"))
    params = model.init(jax.random.PRNGKey(0))
    def prompt(vocab, length, seed):
        data = DataConfig(vocab=vocab, seq_len=length, global_batch=1, seed=seed)
        return np.asarray(batch_at(data, 0)["tokens"][0], np.int32)
    lens = json.loads(sys.argv[2])
    reqs = [Request(id=i, tokens=prompt(model.cfg.vocab, n, 500 + i), max_new_tokens=6,
                    arrival_step=i) for i, n in enumerate(lens)]
    eng = ContinuousEngine(model, params, num_slots=4, max_seq=int(sys.argv[3]),
                           cfg=ServeConfig(), chunk=int(sys.argv[4]), block_size=int(sys.argv[5]),
                           devices=2, paged=True)
    assert eng.mesh is not None
    comps = eng.run(reqs)
    plain = lambda x: x.item() if isinstance(x, np.generic) else x
    m = {k: ([plain(x) for x in v] if isinstance(v, (list, tuple)) else plain(v))
         for k, v in eng.metrics().items()}
    weights = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                        for x in jax.tree.leaves(params)))
    print(json.dumps({
        "tokens": {str(c.request_id): np.asarray(c.new_tokens).tolist() for c in comps},
        "events": [[plain(x) for x in e] for e in eng.event_log],
        "metrics": m, "weights": weights}))
""")


def test_two_shards_equal_the_jax_engine_over_two_devices():
    jmodel, jparams, model, master = pair(ARCH)
    reqs = to_port([JaxRequest(id=i, tokens=prompt(jmodel.cfg.vocab, n, 500 + i),
                               max_new_tokens=6, arrival_step=i) for i, n in enumerate(LENS)])
    max_seq = max(r.prompt_len + r.max_new_tokens for r in reqs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    run = subprocess.run([sys.executable, "-c", CHILD, ARCH, json.dumps(LENS), str(max_seq),
                          str(CHUNK), str(BLOCK)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    weights = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                        for x in jax.tree.leaves(jparams)))
    assert ref["weights"] == weights  # the subprocess drew the same weights

    eng = ContinuousEngine(model, master, num_slots=4, max_seq=max_seq, cfg=ServeConfig(),
                           chunk=CHUNK, block_size=BLOCK, devices=2, device="cpu")
    comps = eng.run(reqs)
    assert {str(c.request_id): c.new_tokens.tolist() for c in comps} == ref["tokens"]
    events = [list(e) for e in eng.event_log]
    assert events == ref["events"]
    m = eng.metrics()
    assert m["device_admits"] == ref["metrics"]["device_admits"] == [3, 2]
    shared = sorted((set(m) & set(ref["metrics"])) - OWN)
    assert {k: m[k] for k in shared} == {k: ref["metrics"][k] for k in shared}
    assert {"num_devices", "per_device_slots", "shard_balance"} <= set(shared)
