"""Continuous batching with the GN datapath: a serving timeline (port of
``examples/serve_continuous.py``).

A synthetic staggered-arrival workload (mixed prompt lengths and decode
budgets) streams through the scheduler, the block-paged KV pool and the
fused prefill/decode tick: admitted prompts drain chunk by chunk (P marks)
while other slots decode (D marks).  The timeline shows requests joining
and leaving the running batch; the epilogue holds the greedy outputs
against the static path.

``--devices N`` shards the slot pool over N devices (``cuda:0 ..
cuda:N-1``, or N shards of ``--device`` when it is given, ``--num-slots``
rounded up to a multiple of N): the timeline splits the slot marks by
device (``|``) and gives each tick's live slots a device; the epilogue the
admissions a device and their balance.

``--shared-prefix``: N users over one system prompt and a few persona
preambles (``shared_prefix_requests``), with the radix prefix cache on.
Each admission is annotated with the blocks it attached (``hit req3:
18tok/4blk+fork``); the epilogue gives the hit rate, the copy-on-write
forks and the evictions.

``--sla``: the bursty two-class workload (``sla_requests``) under priority
scheduling with an aging bound and preemption (``--preempt spill`` or
``recompute``).  Slot marks carry the class (upper case interactive, lower
case batch); preemptions, resumes and rejections are annotated; the
epilogue gives each class's arrival-anchored TTFT on the step clock.

Runs on CUDA unless ``--device`` says otherwise.

Usage:
  python -m repro_torch.examples.serve_continuous --device cpu [--arch internlm2-1.8b]
  python -m repro_torch.examples.serve_continuous --device cpu --devices 2
  python -m repro_torch.examples.serve_continuous --device cpu --shared-prefix
  python -m repro_torch.examples.serve_continuous --device cpu --sla [--preempt recompute]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.models.transformer import make_model
from repro_torch.serve.engine import (ContinuousEngine, ServeConfig, round_slots_to_devices,
                                      static_reference)
from repro_torch.serve.workload import (required_max_seq, shared_prefix_requests, sla_requests,
                                        staggered_requests)


def _mark(st) -> str:
    """. idle, P prefilling, D decoding; lower case for a batch request."""
    if st is None:
        return "."
    m = "P" if st.phase == "prefilling" else "D"
    return m.lower() if st.req.req_class == "batch" else m


def _event(e) -> str:
    if e[0] == "preempt":
        return f"preempt req{e[2]}@slot{e[4]}({e[3]})"
    if e[0] == "resume":
        return f"resume req{e[2]}@slot{e[3]}"
    return f"REJECT req{e[2]}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--num-slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the slot pool over N devices (N shards of --device if given)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="shared system-prompt workload + radix prefix cache")
    ap.add_argument("--sla", action="store_true",
                    help="bursty two-class workload + priority scheduling and preemption")
    ap.add_argument("--preempt", default="spill", choices=["spill", "recompute"],
                    help="preemption mechanism under --sla")
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    args = ap.parse_args(argv)
    if args.sla and args.shared_prefix:
        ap.error("--sla and --shared-prefix are separate demos")
    device = resolve_device(args.device)

    cfg = reduce_config(get_config(args.arch))
    model = make_model(cfg)
    master = model.init(0, device)
    if args.shared_prefix:
        reqs = shared_prefix_requests(cfg, n_users=args.requests, n_personas=3, system_len=24,
                                      persona_len=10, user_len=6,
                                      max_new_tokens=args.new_tokens, stagger=4, seed=3)
    elif args.sla:
        reqs = sla_requests(cfg, n_requests=args.requests, base_len=12, rate=0.4,
                            max_new_interactive=args.new_tokens // 2,
                            max_new_batch=2 * args.new_tokens, seed=3)
    else:
        reqs = staggered_requests(cfg, n_requests=args.requests, base_len=16,
                                  max_new_tokens=args.new_tokens, stagger=2, seed=3)
    num_slots = round_slots_to_devices(args.num_slots, args.devices)
    engine = ContinuousEngine(model, master, num_slots=num_slots,
                              max_seq=required_max_seq(reqs), cfg=ServeConfig(),
                              prefix_cache=args.shared_prefix,
                              sched="priority" if args.sla else "fcfs",
                              preempt=args.preempt if args.sla else "off", aging_steps=24,
                              devices=args.devices,
                              device=device if args.devices == 1 else args.device)
    for r in reqs:
        engine.submit(r)
    kind = "shared-prefix " if args.shared_prefix else "sla " if args.sla else ""
    print(f"{args.requests} {kind}requests / {num_slots} slots on {args.devices} device(s) "
          f"({', '.join(str(d) for d in engine.shard_devices)}) "
          f"(prompt lens {sorted({r.prompt_len for r in reqs})}, "
          f"max_new {sorted({r.max_new_tokens for r in reqs})})\n")
    done = seen_hits = seen_events = 0
    t0 = time.time()
    while engine.step():
        newly = engine.completions[done:]
        done = len(engine.completions)
        pds = engine.pool.per_device_slots
        marks = "|".join("".join(_mark(st) for st in engine._slots[d * pds:(d + 1) * pds])
                         for d in range(engine.num_devices))
        live = sum(st is not None for st in engine._slots)
        dev = f"  per-device {engine.device_occupancy()}" if engine.num_devices > 1 else ""
        hits = list(engine.request_prefix_hits.items())[seen_hits:]
        seen_hits += len(hits)
        hit = " ".join(f"hit req{rid}: {h['tokens']}tok/{h['blocks']}blk"
                       + ("+fork" if h["forked"] else "") for rid, h in hits)
        events = engine.event_log[seen_events:]
        seen_events = len(engine.event_log)
        sla = " ".join(_event(e) for e in events if e[0] in ("preempt", "resume", "reject"))
        fin = " ".join(f"req{c.request_id}[{c.finish_reason}]" for c in newly)
        print(f"step {engine.step_count - 1:3d}  slots [{marks}] active={live}{dev}"
              + (f"  {hit}" if hit else "") + (f"  {sla}" if sla else "")
              + (f"  finished: {fin}" if fin else ""))
    dt = time.time() - t0

    m = engine.metrics()
    print(f"\nserved {m['completions']} requests, {m['generated_tokens']} tokens in {dt:.2f}s "
          f"({m['generated_tokens'] / dt:.1f} tok/s)")
    print(f"slot utilization {m['mean_slot_utilization'] * 100:.0f}%  graph captures "
          f"{m['fused_step_compilations'] + m['decode_compilations']} (one per step kind and "
          "horizon bucket on the card, none on the CPU)")
    if engine.num_devices > 1:
        print(f"sharded: {m['num_devices']} devices x {m['per_device_slots']} slots — "
              f"admissions/device {m['device_admits']}, balance {m['shard_balance']:.2f} "
              "(1.0 = perfectly even)")
    if args.shared_prefix:
        print(f"prefix cache: hit rate {m['prefix_hit_rate'] * 100:.0f}% "
              f"({m['prefix_hit_tokens']}/{m['prefix_prompt_tokens']} prompt tokens), "
              f"{m['prefix_hit_requests']} hit requests, {m['prefix_forks']} COW forks, "
              f"{m['prefix_evictions']} evictions, {m['prefix_cached_blocks']} blocks retained")
    if args.sla:
        print(f"sla: {m['preemptions']} preemptions ({m['preempt_mode']}), "
              f"{m['preempt_resumes']} resumes, {m['rejections']} rejections")
        for klass in ("interactive", "batch"):
            cs = [c for c in engine.completions
                  if c.req_class == klass and c.finish_reason != "rejected"]
            if cs:
                ttft = [c.ttft_steps for c in cs]
                wait = [c.queue_wait_steps for c in cs]
                print(f"  {klass:<11} n={len(cs):2d}  ttft_steps p50 {np.median(ttft):.0f} "
                      f"max {max(ttft)}  queue_wait p50 {np.median(wait):.0f} max {max(wait)}")
    served = [c for c in engine.completions if c.finish_reason != "rejected"]
    lat = [c.latency_s for c in served]
    print(f"latency p50 {np.median(lat) * 1e3:.0f}ms  max {max(lat) * 1e3:.0f}ms")
    ref = static_reference(model, engine.params, reqs, ServeConfig())
    same = sum(np.array_equal(c.tokens, ref[c.request_id]) for c in served)
    print(f"greedy outputs token-identical to the static engine: {same}/{len(served)}")
    return {"engine": engine, "requests": reqs, "static_identical": same, "served": len(served)}


if __name__ == "__main__":
    main()
