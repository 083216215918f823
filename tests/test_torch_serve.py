"""The port's serving stack on the CPU against the JAX engine: greedy tokens
of the mixed workload identical to the reference ``ContinuousEngine`` at
float32 over block sizes {4, 8}, full drain, reset-replay, the engine's
telemetry (``metrics()`` and ``Completion``) equal to the reference's on
their shared keys, the pool's block bookkeeping, the prefix cache and the
SLA options on the same workload, and the refusals of what is not ported.
Three reduced dense configs: internlm2-1.8b (gn_rms, GQA, SwiGLU),
stablelm-1.6b (gn_ln, MHA) and gpt-neo-1.3b (gn_ln, gelu; Table I's
backbone)."""
import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduce_config as jax_reduce_config
from repro.data.synthetic import DataConfig, batch_at
from repro.models.transformer import make_model as jax_make_model
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_launch
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import ContinuousEngine, ServeConfig, static_reference
from repro_torch.serve.kv_cache import BlockPagedKVPool
from repro_torch.serve.scheduler import Request
from repro_torch.serve.workload import required_max_seq

CHUNK = 4
LENS = [5, 9, 14, 22, 7]  # the reference's _mixed_requests (tests/test_serve_paged.py)
# the engines' horizon-bucket metrics: the grid and the buckets each step
# kind ran at (one trace, or one CUDA graph, per (kind, bucket))
BUCKET_KEYS = ("horizon_bucket_grid", "horizon_buckets", "fused_buckets", "decode_buckets")


def _prompt(vocab, length, seed):
    data = DataConfig(vocab=vocab, seq_len=length, global_batch=1, seed=seed)
    return np.asarray(batch_at(data, 0)["tokens"][0], np.int32)


def _mixed(vocab, cls, max_new=4):
    return [cls(id=i, tokens=_prompt(vocab, n, 300 + i), max_new_tokens=max_new,
                arrival_step=i) for i, n in enumerate(LENS)]


def _tokens(comps):
    return {c.request_id: c.new_tokens.tolist() for c in comps}


# the Completion fields compared with the reference's (wall-clock fields
# aside); the step-clock properties are the reference's arrival-anchored ones
COMPLETION_KEYS = ("request_id", "finish_reason", "arrival_step", "admit_step",
                   "first_token_step", "finish_step", "queue_wait_steps", "ttft_steps",
                   "tpot_steps")


@pytest.fixture(scope="module", params=["internlm2-1.8b", "stablelm-1.6b", "gpt-neo-1.3b"])
def reference(request):
    """The JAX engine's greedy tokens and horizon buckets, and its weights
    as numpy, per dtype and block size (float32 at {4, 8}, bfloat16 at 4);
    at float32 also its metrics and completions, for the fixture's arch."""
    out = {"arch": request.param}
    for dtype, sizes in (("float32", (4, 8)), ("bfloat16", (4,))):
        cfg = jax_reduce_config(jax_get_config(request.param), dtype=dtype)
        model = jax_make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        reqs = _mixed(cfg.vocab, JaxRequest)
        for bs in sizes:
            eng = JaxEngine(model, params, num_slots=2, max_seq=required_max_seq(reqs),
                            cfg=JaxServeConfig(), chunk=CHUNK, block_size=bs, sentinels=False)
            comps = eng.run(reqs)
            out[dtype, bs] = _tokens(comps)
            out["buckets", dtype, bs] = {k: eng.metrics()[k] for k in BUCKET_KEYS}
            if dtype == "float32":
                out["metrics", bs] = eng.metrics()
                out["completions", bs] = {c.request_id: {k: getattr(c, k) for k in
                                                         COMPLETION_KEYS} for c in comps}
        out[dtype] = jax.tree.map(np.asarray, params)
    return out


def _engine(reference, dtype, bs, **kw):
    cfg = reduce_config(get_config(reference["arch"]), dtype=dtype)
    model = make_model(cfg)
    params = params_from_numpy(model, reference[dtype], device="cpu")
    reqs = _mixed(cfg.vocab, Request)
    kw = {"cfg": ServeConfig(), "num_slots": 2, "max_seq": required_max_seq(reqs),
          "chunk": CHUNK, "block_size": bs, "device": "cpu", **kw}
    return ContinuousEngine(model, params, **kw), reqs


@pytest.mark.parametrize("bs", [4, 8])
def test_greedy_tokens_identical_to_jax_engine_f32(reference, bs):
    eng, reqs = _engine(reference, "float32", bs)
    comps = eng.run(reqs)
    assert _tokens(comps) == reference["float32", bs]
    assert all(c.finish_reason == "length" for c in comps)
    # drained: every block and slot is back on its free list
    assert eng.pool.blocks_in_use == 0 and eng.pool.blocks_reserved == 0
    assert eng.pool.num_free == eng.pool.num_slots
    assert eng.pool.peak_blocks_in_use > 0
    # reset-replay: recycled blocks are not zeroed, yet tokens are identical
    eng.reset()
    assert _tokens(eng.run(reqs)) == reference["float32", bs]


@pytest.mark.parametrize("bs", [4, 8])
def test_horizon_buckets_equal_jax_engine(reference, bs):
    """On the same workload the port's tick reads the horizon buckets the
    JAX engine traced, per step kind, with its greedy tokens still equal at
    float32; the CPU captures no graph."""
    eng, reqs = _engine(reference, "float32", bs)
    assert _tokens(eng.run(reqs)) == reference["float32", bs]
    m = eng.metrics()
    assert {k: m[k] for k in BUCKET_KEYS} == reference["buckets", "float32", bs]
    assert len(m["horizon_buckets"]) >= 2 and m["kv_paged"]
    assert (m["fused_step_compilations"], m["decode_compilations"],
            m["prefill_compilations"]) == (0, 0, 0)


# bf16 greedy tokens that agree with the JAX engine's, of 20, measured per
# arch on this workload
BF16_AGREE = {"internlm2-1.8b": 17, "stablelm-1.6b": 20, "gpt-neo-1.3b": 20}


def test_greedy_tokens_bf16_agreement(reference):
    """bf16 rounds at other places in the two packages (the reference rounds
    scores and probabilities to bf16, the port's read keeps them in f32), so
    greedy paths may part.  Measured on this workload for internlm2-1.8b:
    17 of 20 tokens agree; request 2 parts at its second token, where the
    port's bf16 tokens stay on the float32 path of both packages and the
    reference's bf16 run leaves it.  The test pins the measurement of each
    arch (``BF16_AGREE``)."""
    eng, reqs = _engine(reference, "bfloat16", 4)
    mine, ref = _tokens(eng.run(reqs)), reference["bfloat16", 4]
    agree = sum(a == b for i in ref for a, b in zip(mine[i], ref[i]))
    total = sum(len(t) for t in ref.values())
    print(f"{reference['arch']} bf16 greedy agreement with the JAX engine: {agree}/{total}")
    assert agree >= BF16_AGREE[reference["arch"]]
    if reference["arch"] == "internlm2-1.8b":
        assert mine[2] == reference["float32", 4][2]


@pytest.mark.parametrize("bs", [4, 8])
def test_telemetry_equals_jax_engine_f32(reference, bs):
    """``metrics()`` and every ``Completion`` on the mixed workload at f32,
    sentinels off as in the fixture: each key the two engines share equals
    the reference's, but for what the port measures otherwise by design:
    its graph captures and replays (none on the CPU) stand for the
    reference's compilations and transfer-guarded ticks, its read is the
    kernel where the reference's default is the streamed read, and
    ``kv_hbm_bytes`` also counts the port's write-sink block.  Wall-clock
    fields are held to their order only."""
    eng, reqs = _engine(reference, "float32", bs, sentinels=False)
    comps = eng.run(reqs)
    mine, ref = eng.metrics(), reference["metrics", bs]
    own = {"fused_step_compilations", "decode_compilations", "prefill_compilations",
           "transfer_guarded_ticks", "read_path", "kv_hbm_bytes"}
    shared = sorted((set(mine) & set(ref)) - own)
    for key in ("completions", "mean_slot_utilization", "prefill_lane_fraction", "chunk",
                "intake_padding", "peak_blocks_reserved", "mean_attended_tokens_per_tick"):
        assert key in shared
    assert {k: mine[k] for k in shared} == {k: ref[k] for k in shared}
    cache = eng.pool.caches[0]
    sink = sum(t[:, -1].numel() * t.element_size() for t in cache.values())
    assert mine["kv_hbm_bytes"] == ref["kv_hbm_bytes"] + sink
    assert mine["completed"] == mine["completions"] == len(reqs)
    got = {c.request_id: {k: getattr(c, k) for k in COMPLETION_KEYS} for c in comps}
    assert got == reference["completions", bs]
    for c in comps:
        assert 0.0 <= c.ttft_s <= c.latency_s


def test_pool_reserve_ensure_recycle():
    model = make_model(reduce_config(get_config("internlm2-1.8b")))
    pool = BlockPagedKVPool(model, num_slots=3, max_seq=16, block_size=4, num_blocks=6,
                            device="cpu")
    assert pool.caches[0]["k"].shape[1] == 7  # six blocks and the write sink
    s0 = pool.allocate(reserve_tokens=12)
    s1 = pool.allocate(reserve_tokens=12)
    assert pool.blocks_reserved == 6
    assert not pool.can_reserve(1)
    with pytest.raises(RuntimeError):
        pool.allocate(reserve_tokens=4)
    pool.ensure(s0, 5)
    assert list(pool.tables[s0, :2]) == [0, 1] and pool.blocks_in_use == 2
    pool.ensure(s1, 12)
    assert list(pool.tables[s1, :3]) == [2, 3, 4]
    with pytest.raises(RuntimeError, match="reservation"):
        pool.ensure(s0, 13)
    pool.free(s0)
    assert pool.blocks_in_use == 3 and pool.can_reserve(8)
    s2 = pool.allocate(reserve_tokens=8)
    pool.ensure(s2, 8)
    assert list(pool.tables[s2, :2]) == [5, 0]  # FIFO recycling
    with pytest.raises(ValueError):
        pool.ensure(s2, 17)
    pool.free(s1)
    pool.free(s2)
    assert pool.blocks_in_use == 0 and pool.blocks_reserved == 0 and pool.num_free == 3
    with pytest.raises(ValueError):
        pool.free(s2)


def test_admission_waits_for_blocks_and_unservable_raises(reference):
    # footprint 12 tokens = 3 blocks each; a 3-block arena serves the two
    # requests one after the other though two slots are free
    eng, _ = _engine(reference, "float32", CHUNK, max_seq=12, num_blocks=3)
    reqs = [Request(id=i, tokens=_prompt(eng.model.cfg.vocab, 8, 330 + i), max_new_tokens=4)
            for i in range(2)]
    first, second = sorted(eng.run(reqs), key=lambda c: c.request_id)
    assert second.admit_step >= first.finish_step
    assert eng.pool.peak_blocks_in_use <= 3
    # a footprint larger than the whole arena fails at admission
    eng, _ = _engine(reference, "float32", CHUNK, max_seq=12, num_blocks=2)
    with pytest.raises(ValueError, match="unservable"):
        eng.run([Request(id=0, tokens=_prompt(eng.model.cfg.vocab, 8, 340), max_new_tokens=2)])


@pytest.mark.parametrize("kw", [{"devices": 2}, {"paged": False}, {"devices": 4}])
def test_unported_options_are_refused(reference, kw):
    # sampling, the GN sentinels, the prefix cache, the SLA control plane,
    # the slab pool and sharded serving are ported (tests/test_torch_sampling.py,
    # test_torch_sentinels.py, test_torch_prefix.py, test_torch_sla.py,
    # test_torch_slab.py, test_torch_sharded.py): two shards of the CPU serve
    # the one-device tokens, and slots that do not divide over the devices
    # are refused, as the reference refuses them
    if "devices" in kw:
        if kw["devices"] == 2:
            eng, reqs = _engine(reference, "float32", 4, **kw)
            assert _tokens(eng.run(reqs)) == reference["float32", 4]
            assert eng.metrics()["num_devices"] == 2
            return
        with pytest.raises(ValueError, match="divide evenly"):
            _engine(reference, "float32", 4, **kw)
        return
    if kw.get("paged") is False:
        # the slab pool: a block size is refused as the reference refuses it,
        # and without one the slab engine serves the paged engine's f32 tokens
        with pytest.raises(ValueError, match="block_size"):
            _engine(reference, "float32", 4, **kw)
        eng, reqs = _engine(reference, "float32", 0, sentinels=False, **kw)
        assert _tokens(eng.run(reqs)) == reference["float32", 4]
        assert eng.metrics()["read_path"] == "slab"


@pytest.mark.parametrize("kw", [
    {"prefix_cache": True}, {"sched": "priority"}, {"sched": "priority", "preempt": "spill"},
    {"sched": "priority", "preempt": "recompute"},
])
def test_prefix_and_sla_options_serve_the_fcfs_tokens(reference, kw):
    """The options the earlier slices refused: on the mixed workload (all
    requests interactive, no prefix shared past a block) each serves the
    JAX FCFS engine's greedy tokens and drains."""
    eng, reqs = _engine(reference, "float32", 4, **kw)
    assert _tokens(eng.run(reqs)) == reference["float32", 4]
    m = eng.metrics()
    assert m["preemptions"] == m["rejections"] == 0 and eng.pool.num_free == eng.pool.num_slots
    assert m["sched"] == kw.get("sched", "fcfs") and m["prefix_cache"] == ("prefix_cache" in kw)


def test_sampled_request_is_refused(reference):
    """The engine serves a sampled request now; the greedy oracle refuses
    one, as the reference's does."""
    eng, reqs = _engine(reference, "float32", 4)
    sampled = Request(id=0, tokens=reqs[0].tokens, max_new_tokens=2, temperature=0.7)
    with pytest.raises(ValueError, match="greedy oracle"):
        static_reference(eng.model, eng.params, [sampled], ServeConfig())
    eng.submit(sampled)
    assert len(eng.run([])) == 1


def test_launch_serves_a_seeded_workload_on_cpu(capsys):
    out = serve_launch.main(["--smoke", "--continuous", "--device", "cpu", "--requests", "3",
                             "--num-slots", "2", "--new-tokens", "3", "--max-prompt", "12"])
    assert len(out["completions"]) == 3
    assert all(len(c.new_tokens) == 3 for c in out["completions"])
    text = capsys.readouterr().out
    assert "req 2: prompt" in text and "ticks    0+" in text
    assert "greedy outputs token-identical to static path: " in text
    # the static mode, the launcher's default, serves too
    out = serve_launch.main(["--smoke", "--device", "cpu", "--batches", "1", "--new-tokens", "2"])
    assert tuple(out["outputs"][0].shape) == (4, 34)
    assert "seq ppl" in capsys.readouterr().out
