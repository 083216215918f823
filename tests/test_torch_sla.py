"""The port's SLA control plane on the CPU against the JAX package: the
one-device paged dense cases of the reference's tests/test_serve_sla.py,
held to the JAX engine on the same converted weights and tokens.

  * engine (reduced internlm2-1.8b, f32, chunk 4, sentinels on): greedy
    tokens, ``event_log`` (admit, preempt, resume, reject, finish, each with
    its step), ``request_prefix_hits``, completions (``req_class``,
    ``preemptions``, "rejected"), the shared ``metrics()`` keys and the
    final tables and refcounts equal the JAX engine's for: preemption with
    recompute and with spill resumes (fp and int8 pools) and their reset
    replays, preemption under the prefix cache, the bursty two-class
    workload, the aging bound, shedding (batch only, head-ordered), a
    preempted request never shed, and the idle fast-forward (priority and
    FCFS); the served tokens equal the JAX static oracle's;
  * the schedulers: the rank rule, next-ready and requeue, the shedding
    watermark and the class check, equal to the JAX schedulers' on the same
    submissions; the engine's option checks; the step-clock fields of a
    ``Completion``; ``sla_requests``' arrivals, classes, lengths and budgets
    equal to the reference's draws.
"""
import numpy as np
import pytest

from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import static_reference as jax_static_reference
from repro.serve.scheduler import FCFSScheduler as JaxFCFS
from repro.serve.scheduler import PriorityScheduler as JaxPriority
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.workload import sla_requests as jax_sla_requests
from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.serve.scheduler import (FINISH_REASONS, REQUEST_CLASSES, Completion,
                                         FCFSScheduler, PriorityScheduler, Request)
from repro_torch.serve.workload import sla_requests

from _torch_parity import (assert_same, dense, jax_engine, port_engine, prompt, run,
                           set_policy, to_port)


def _preempt_reqs(vocab, slots=2):
    """``slots`` long batch requests fill every slot at step 0; an
    interactive request arrives mid-decode with no slot free."""
    batch = [JaxRequest(id=i, tokens=prompt(vocab, 9 + i, 400 + i), max_new_tokens=10,
                        arrival_step=0, req_class="batch") for i in range(slots)]
    return batch + [JaxRequest(id=slots, tokens=prompt(vocab, 6, 410), max_new_tokens=4,
                               arrival_step=8, req_class="interactive")]


def _prefix_preempt_reqs(vocab):
    """Two batch requests share a 9-token prefix, so the victim's chain
    holds indexed blocks when it is evicted."""
    base = prompt(vocab, 12, seed=500)
    return [JaxRequest(id=0, tokens=base[:9], max_new_tokens=10, arrival_step=0,
                       req_class="batch"),
            JaxRequest(id=1, tokens=base, max_new_tokens=10, arrival_step=1, req_class="batch"),
            JaxRequest(id=2, tokens=prompt(vocab, 6, 510), max_new_tokens=4, arrival_step=10,
                       req_class="interactive")]


def _shed_reqs(vocab):
    """4 batch requests of 6 blocks each and 2 interactive ones at once."""
    return ([JaxRequest(id=i, tokens=prompt(vocab, 16, 700 + i), max_new_tokens=8,
                        arrival_step=0, req_class="batch") for i in range(4)]
            + [JaxRequest(id=4 + i, tokens=prompt(vocab, 8, 720 + i), max_new_tokens=4,
                          arrival_step=1, req_class="interactive") for i in range(2)])


def _aging_reqs(vocab):
    """One slot, a long interactive request, a batch request at step 1, and
    an interactive stream behind it (arrivals 2, 4, ..., 12)."""
    return ([JaxRequest(id=0, tokens=prompt(vocab, 8, 600), max_new_tokens=6, arrival_step=0,
                        req_class="interactive"),
             JaxRequest(id=1, tokens=prompt(vocab, 8, 601), max_new_tokens=4, arrival_step=1,
                        req_class="batch")]
            + [JaxRequest(id=2 + i, tokens=prompt(vocab, 4, 610 + i), max_new_tokens=2,
                          arrival_step=2 + 2 * i, req_class="interactive") for i in range(6)])


def _idle_reqs(vocab):
    return [JaxRequest(id=0, tokens=prompt(vocab, 8, 800), max_new_tokens=4, arrival_step=400,
                       req_class="interactive")]


# (case name) -> (workload, engine group, policy); the groups are the JAX
# engines of one construction (slots, max_seq, pool), each policy set on it
# by attribute and a reset, which keeps its compiled ticks
CASES = {
    "recompute": ("preempt", "slots2", {"preempt_mode": "recompute"}),
    "spill": ("preempt", "slots2", {"preempt_mode": "spill"}),
    "workload": ("sla", "slots2", {"preempt_mode": "spill", "aging_steps": 32}),
    "shed": ("shed", "slots2", {"preempt_mode": "spill", "shed_backlog": 20}),
    "resumed_never_shed": ("preempt", "slots2", {"preempt_mode": "spill", "shed_backlog": 10}),
    "int8_spill": ("preempt", "int8", {"preempt_mode": "spill"}),
    "int8_recompute": ("preempt", "int8", {"preempt_mode": "recompute"}),
    "prefix_spill": ("prefix", "prefix", {"preempt_mode": "spill"}),
    "prefix_recompute": ("prefix", "prefix", {"preempt_mode": "recompute"}),
    "aging": ("aging", "slots1", {"preempt_mode": "off", "aging_steps": 6}),
    "idle_priority": ("idle", "slots1", {"preempt_mode": "off"}),
    "idle_fcfs": ("idle", "slots1", {"sched_policy": "fcfs", "preempt_mode": "off"}),
}
GROUPS = {
    "slots2": {"num_slots": 2, "max_seq": 32},
    "int8": {"num_slots": 2, "max_seq": 32, "kv_dtype": "int8"},
    "prefix": {"num_slots": 2, "max_seq": 32, "prefix_cache": True, "num_blocks": 24},
    "slots1": {"num_slots": 1, "max_seq": 16},
}


def _port_kwargs(case):
    _, group, policy = CASES[case]
    names = {"sched_policy": "sched", "preempt_mode": "preempt"}
    kw = {"sched": "priority", **{names.get(k, k): v for k, v in policy.items()}}
    return {**GROUPS[group], **kw}


@pytest.fixture(scope="module")
def runs():
    """Every case's JAX run (and, for the preemption cases, its reset
    replay), and the JAX static oracle's tokens per workload."""
    jmodel, jparams, model, master = dense()
    vocab = jmodel.cfg.vocab
    reqs = {"preempt": _preempt_reqs(vocab), "prefix": _prefix_preempt_reqs(vocab),
            "shed": _shed_reqs(vocab), "aging": _aging_reqs(vocab), "idle": _idle_reqs(vocab),
            "sla": jax_sla_requests(jmodel.cfg, n_requests=8, base_len=8, rate=0.6, seed=13,
                                    max_new_interactive=4, max_new_batch=8)}
    engines = {g: jax_engine(jmodel, jparams, sched="priority", preempt="spill", **kw)
               for g, kw in GROUPS.items()}
    out = {"model": model, "master": master, "reqs": reqs, "jax": {}, "replay": {}}
    for case, (workload, group, policy) in CASES.items():
        eng = set_policy(engines[group], **{"sched_policy": "priority", "aging_steps": 64,
                                           "shed_backlog": 0, **policy})
        out["jax"][case] = run(eng, reqs[workload])
        eng.reset()
        out["replay"][case] = run(eng, reqs[workload])
    out["oracle"] = {}
    for name, rs in reqs.items():
        ref = jax_static_reference(jmodel, jparams, rs, JaxServeConfig())
        out["oracle"][name] = {i: np.asarray(t).tolist() for i, t in ref.items()}
    return out


def _port_run(runs, case):
    eng = port_engine(runs["model"], runs["master"], **_port_kwargs(case))
    return eng, run(eng, to_port(runs["reqs"][CASES[case][0]]))


def _oracle_identical(got, runs, workload):
    """Every served request (rejected ones aside) equals the static oracle."""
    reqs = {r.id: r for r in runs["reqs"][workload]}
    for rid, c in got["completions"].items():
        if c["finish_reason"] != "rejected":
            want = runs["oracle"][workload][rid]
            assert list(reqs[rid].tokens) + got["tokens"][rid] == want, f"req {rid}"


# ------------------------------------------------- exact resume, paged ------
@pytest.mark.parametrize("case", ["recompute", "spill", "int8_recompute", "int8_spill"])
def test_preempt_resume_identity_paged(runs, case):
    eng, got = _port_run(runs, case)
    assert_same(got, runs["jax"][case])
    _oracle_identical(got, runs, "preempt")
    m = got["metrics"]
    assert m["preemptions"] >= 1 and m["preempt_resumes"] == m["preemptions"]
    comps = got["completions"]
    assert sum(c["preemptions"] for c in comps.values()) == m["preemptions"]
    assert comps[2]["preemptions"] == 0 and comps[2]["req_class"] == "interactive"
    assert eng.pool.blocks_in_use == 0  # every chain freed or restored once
    trace = got["events"]
    assert any(e[0] == "preempt" for e in trace) and any(e[0] == "resume" for e in trace)
    eng.reset()
    again = run(eng, to_port(runs["reqs"]["preempt"]))
    assert again["events"] == trace and again["tokens"] == got["tokens"]
    assert_same(again, runs["replay"][case])


@pytest.mark.parametrize("case", ["prefix_spill", "prefix_recompute"])
def test_preempt_resume_identity_with_prefix_cache(runs, case):
    """A victim whose chain holds attached (refcount > 1) cache blocks drops
    its references at eviction; its resume builds blocks of its own (spill
    restores the shared values into them) and skips the lookup."""
    eng, got = _port_run(runs, case)
    assert_same(got, runs["jax"][case])
    _oracle_identical(got, runs, "prefix")
    assert got["metrics"]["preemptions"] >= 1 and got["metrics"]["prefix_cache"] is True
    assert got["metrics"]["prefix_inserts"] > 0  # the victim's chain was indexed
    assert eng.pool.num_free == eng.pool.num_slots
    assert eng.pool.blocks_in_use == eng.pool.cached_blocks


def test_sla_workload_trace_determinism(runs):
    eng, got = _port_run(runs, "workload")
    assert_same(got, runs["jax"]["workload"])
    _oracle_identical(got, runs, "sla")
    assert {c["req_class"] for c in got["completions"].values()} == set(REQUEST_CLASSES)
    eng.reset()
    again = run(eng, to_port(runs["reqs"]["sla"]))
    assert again["events"] == got["events"]
    assert_same(again, runs["replay"]["workload"])


def test_aging_prevents_batch_starvation(runs):
    """One slot: only interactive requests arriving before 1 + 6 outrank
    the batch request of step 1; it is admitted despite the stream."""
    _, got = _port_run(runs, "aging")
    assert_same(got, runs["jax"]["aging"])
    _oracle_identical(got, runs, "aging")
    arrival = {r.id: r.arrival_step for r in runs["reqs"]["aging"]}
    order = [e[2] for e in got["events"] if e[0] == "admit"]
    pos = order.index(1)
    before, after = order[:pos], order[pos + 1:]
    assert before and after
    assert all(arrival[i] < 7 for i in before) and all(arrival[i] >= 7 for i in after)
    assert before == sorted(before) and after == sorted(after)
    assert got["completions"][1]["finish_reason"] == "length"


def test_backpressure_sheds_batch_only_and_deterministically(runs):
    eng, got = _port_run(runs, "shed")
    assert_same(got, runs["jax"]["shed"])
    _oracle_identical(got, runs, "shed")
    comps = got["completions"]
    rejected = [c for c in comps.values() if c["finish_reason"] == "rejected"]
    assert rejected and all(c["req_class"] == "batch" for c in rejected)
    assert all(c["finish_reason"] != "rejected" for c in comps.values()
               if c["req_class"] == "interactive")
    for c in rejected:
        assert c["admit_step"] == c["first_token_step"] == c["ttft_steps"] == -1
        assert c["queue_wait_steps"] == c["finish_step"] - c["arrival_step"] >= 0
        assert got["tokens"][c["request_id"]] == []
    m = got["metrics"]
    assert m["rejections"] == len(rejected) == m["shed_count"]
    assert eng.pool.blocks_in_use == 0
    eng.reset()
    again = run(eng, to_port(runs["reqs"]["shed"]))
    assert again["events"] == got["events"]


def test_resumed_requests_are_never_shed(runs):
    _, got = _port_run(runs, "resumed_never_shed")
    assert_same(got, runs["jax"]["resumed_never_shed"])
    _oracle_identical(got, runs, "preempt")
    assert got["metrics"]["preemptions"] >= 1
    preempted = [c for c in got["completions"].values() if c["preemptions"] > 0]
    assert preempted and all(c["finish_reason"] == "length" for c in preempted)


@pytest.mark.parametrize("case", ["idle_priority", "idle_fcfs"])
def test_idle_fast_forward_jumps_to_next_arrival(runs, case):
    eng = port_engine(runs["model"], runs["master"], **_port_kwargs(case))
    for r in to_port(runs["reqs"]["idle"]):
        eng.submit(r)
    iters = 0
    while eng.step():
        iters += 1
        assert iters < 50, "idle ticks were burned one by one"
    got = run(eng, [])
    assert_same(got, runs["jax"][case])
    (c,) = eng.completions
    assert eng.step_count >= 400 and c.admit_step >= 400
    assert c.queue_wait_steps == c.admit_step - 400 and c.ttft_steps >= 0
    assert c.tpot_steps >= 1.0


# --------------------------------------------------------------- schedulers --
def _same_schedulers(script):
    """``script(Priority, FCFS, Request)`` over both packages' classes: the
    same submissions give the same outcomes."""
    got = [list(script(*classes)) for classes in ((JaxPriority, JaxFCFS, JaxRequest),
                                                  (PriorityScheduler, FCFSScheduler, Request))]
    assert got[0] == got[1]


def test_priority_scheduler_rank_rule_and_order():
    tok = np.arange(4, dtype=np.int32)

    def script(Priority, _, Req):
        s = Priority(aging_steps=10)
        s.submit(Req(tokens=tok, arrival_step=0, req_class="batch"))
        s.submit(Req(tokens=tok, arrival_step=5, req_class="interactive"))
        s.submit(Req(tokens=tok, arrival_step=12, req_class="interactive"))
        assert s.peek_ready(5).req_class == "interactive"  # 5 < 0 + 10
        assert s.peek_ready(100).req_class == "interactive"  # step-independent
        yield s.pop_ready(100).arrival_step
        yield s.pop_ready(100).req_class  # 12 >= 0 + 10: the batch head aged past it
        yield s.pop_ready(100).arrival_step
        assert not s.has_pending()
        yield s.outranks(10, 0), s.outranks(9, 0)

    _same_schedulers(script)


def test_priority_scheduler_next_ready_and_requeue():
    tok = np.arange(4, dtype=np.int32)

    def script(Priority, FCFS, Req):
        s = Priority(aging_steps=10)
        s.submit(Req(tokens=tok, arrival_step=7, req_class="batch"))
        s.submit(Req(tokens=tok, arrival_step=3, req_class="interactive"))
        yield s.next_ready_step(), s.peek_ready(2)  # min over both class heads
        r = s.pop_ready(3)
        s.requeue_front(r)
        yield r.id in s._resumed
        yield s.pop_ready(3).id == r.id, r.id in s._resumed
        fc = FCFS()
        fc.submit(Req(tokens=tok, arrival_step=7))
        fc.submit(Req(tokens=tok, arrival_step=3))
        yield fc.next_ready_step()  # FCFS is head-blocking

    _same_schedulers(script)


def test_priority_scheduler_shed_watermark():
    tok = np.arange(4, dtype=np.int32)

    def script(Priority, _, Req):
        s = Priority(aging_steps=10, shed_backlog=5)
        ids = [s.submit(Req(tokens=tok, arrival_step=0, req_class="batch")) for _ in range(4)]
        s.submit(Req(tokens=tok, arrival_step=0, req_class="interactive"))
        s.submit(Req(tokens=tok, arrival_step=50, req_class="batch"))
        shed = s.poll_shed(0, 1, lambda r: 1)
        assert [r.id for r in shed] == [ids[3]]
        yield s.shed_count, len(s)
        s.pop_ready(0)  # the interactive head
        v = s.pop_ready(0)  # the batch head
        s.requeue_front(v)
        shed = s.poll_shed(0, 4, lambda r: 1)
        assert v.id not in [x.id for x in shed] and v.id in s._resumed
        yield [x.id for x in shed], s.shed_count

    _same_schedulers(script)


def test_request_class_and_option_validation(runs):
    tok = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="req_class"):
        PriorityScheduler().submit(Request(tokens=tok, req_class="bulk"))
    with pytest.raises(ValueError, match="aging_steps"):
        PriorityScheduler(aging_steps=0)
    for kw, match in (({"sched": "fcfs", "preempt": "spill"}, "priority"),
                      ({"sched": "edf"}, "sched"), ({"preempt": "evict"}, "preempt")):
        with pytest.raises(ValueError, match=match):
            port_engine(runs["model"], runs["master"], num_slots=1, max_seq=16, **kw)


def test_completion_sla_fields():
    c = Completion(request_id=0, prompt_tokens=np.arange(4, dtype=np.int32),
                   new_tokens=np.arange(3, dtype=np.int32), finish_reason="length",
                   arrival_step=10, admit_step=14, first_token_step=16, finish_step=22,
                   admit_time=0.0, first_token_time=0.0, finish_time=0.0, req_class="batch",
                   preemptions=1)
    assert (c.queue_wait_steps, c.ttft_steps, c.tpot_steps) == (4, 6, (22 - 16) / 2)
    r = Completion(request_id=1, prompt_tokens=np.arange(4, dtype=np.int32),
                   new_tokens=np.zeros(0, np.int32), finish_reason="rejected",
                   arrival_step=10, admit_step=-1, first_token_step=-1, finish_step=12,
                   admit_time=0.0, first_token_time=0.0, finish_time=0.0, req_class="batch")
    assert (r.ttft_steps, r.queue_wait_steps, r.tpot_steps) == (-1, 2, 0.0)
    assert "rejected" in FINISH_REASONS


@pytest.mark.parametrize("kw", [
    {"n_requests": 8, "base_len": 8, "rate": 0.6, "max_new_interactive": 4, "max_new_batch": 8},
    # chip_smoke.py phase 16's stream (its base_len 256 scales the lengths)
    {"n_requests": 48, "base_len": 16, "max_new_interactive": 16, "max_new_batch": 128},
])
def test_sla_requests_draws_equal_the_reference(kw):
    """Arrivals, classes, prompt lengths and budgets come from the same
    numpy stream as the reference's (tokens from each package's corpus)."""
    cfg = reduce_config(get_config("internlm2-1.8b"))
    mine, ref = sla_requests(cfg, **kw), jax_sla_requests(cfg, **kw)
    fields = ("id", "arrival_step", "req_class", "prompt_len", "max_new_tokens")
    assert ([tuple(getattr(r, f) for f in fields) for r in mine]
            == [tuple(getattr(r, f) for f in fields) for r in ref])
    assert {r.req_class for r in mine} == set(REQUEST_CLASSES)


def test_engine_without_preemption_queues_the_interactive_head(runs):
    """Priority with preempt="off": the interactive head waits for a slot
    (no eviction), and its TTFT grows against the preempting run's."""
    kw = {**GROUPS["slots2"], "sched": "priority"}
    eng = port_engine(runs["model"], runs["master"], **kw)
    got = run(eng, to_port(runs["reqs"]["preempt"]))
    assert got["metrics"]["preemptions"] == 0
    spill = runs["jax"]["spill"]["completions"][2]
    assert got["completions"][2]["ttft_steps"] > spill["ttft_steps"]
    _oracle_identical(got, runs, "preempt")
