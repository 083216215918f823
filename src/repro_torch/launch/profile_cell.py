"""Where a step's time goes, against what its work allows (the port's
counterpart of ``repro/launch/profile_cell.py``).

The reference costs a compiled artifact without hardware.  This tool:

* records one eager step of the path with ``analysis.op_walk`` and costs
  it with ``roofline.op_cost`` (matmul FLOPs, unfused bytes, each GN
  kernel's ``work()``);
* on the card, profiles a steady window of the path's steps (graph
  replays for the serving paths, eager steps for training) with
  ``torch.profiler``, taking the window again when the trace lost a GN
  kernel's records;
* prints the top ops by bytes and by FLOPs, each with its bound and its
  share of the step's bound, the top device kernels by time, each GN
  kernel's device time beside its ``work()`` bound, the step's whole bound
  beside its device time and its wall time, and the peak memory, with the
  card's name and power limit.

With ``--device cpu`` it prints the counts and "not measured" for every
time.

Usage:
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path continuous
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path continuous \
      --kv-dtype int8 --layers 4 --top 20
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path continuous \
      --read streamed
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path static
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path train
  python -m repro_torch.launch.profile_cell --arch internlm2-1.8b --path continuous \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.analysis.op_walk import OpRecord, record
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.kernels import counters
from repro_torch.launch.serve import set_matmul_precision
from repro_torch.models import attention
from repro_torch.models.transformer import make_model
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_cost import OpCost, cost_breakdown, kernel_work, module_cost
from repro_torch.serve.engine import ContinuousEngine, static_decoder
from repro_torch.serve.workload import required_max_seq, seeded_requests
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

NOT_MEASURED = "not measured"
# each GN kernel: its wrapper's record names (``work()``), its launch
# counters, and its device kernels' names (the paged read's range merge is
# part of its call)
KERNELS = {
    "gn_paged_attention": (("gn_paged_attention", "gn_paged_attention_int8"),
                           ("gn_paged_attention", "gn_paged_attention_int8"),
                           ("gn_paged_attention_kernel", "gn_paged_attention_tc_kernel",
                            "gn_paged_attention_merge")),
    "gn_rmsnorm": (("gn_rmsnorm", "gn_rmsnorm_fused"), ("gn_rmsnorm",),
                   ("norm_warp_kernel", "norm_block_kernel", "norm_stream_kernel")),
    "gn_softmax": (("gn_softmax", "gn_softmax_scores"), ("gn_softmax",),
                   ("gn_softmax_rows_kernel", "gn_softmax_wide_kernel")),
    "gn_attention": (("gn_attention",), ("gn_attention",),
                     ("gn_attention_kernel", "gn_attention_tc_kernel")),
}
TRACE_ATTEMPTS = 3


@dataclasses.dataclass
class Cell:
    """A path ready to profile: ``step`` runs one eager step (recorded),
    ``window(n)`` runs n steady steps as the path runs them, each window
    after ``rewind``."""

    label: str
    step: Callable[[], object]
    window: Callable[[int], None]
    device: torch.device
    rewind: Callable[[], None] = lambda: None  # before each window, outside its timing


def kernel_group(device_name: str) -> str | None:
    """The GN kernel a device kernel belongs to, or None."""
    for group, (_, _, names) in KERNELS.items():
        if any(n in device_name for n in names):
            return group
    return None


def device_kernels(prof) -> dict[str, tuple[float, int]]:
    """Device kernel name -> (device us, records) in a CUDA trace."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            out[e.key] = (us if us is not None else e.self_cuda_time_total, e.count)
    return out


def traced_window(cell: Cell, steps: int, attempts: int = TRACE_ATTEMPTS) -> dict:
    """``steps`` steady steps under the profiler (taken again, up to
    ``attempts`` times, while a GN kernel's main device records fall short
    of its launches), and untraced for the wall time."""
    cell.rewind()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell.window(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for attempt in range(1, attempts + 1):
        cell.rewind()
        counters.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            cell.window(steps)
            torch.cuda.synchronize()
        launches = counters.launch_counts()
        kernels = device_kernels(prof)
        records = {g: sum(n for k, (_, n) in kernels.items() if kernel_group(k) == g
                          and "merge" not in k) for g in KERNELS}
        want = {g: sum(launches[c] for c in KERNELS[g][1]) for g in KERNELS}
        if all(records[g] >= want[g] for g in KERNELS):
            break
    return {"kernels": kernels, "prof": prof, "wall_s": wall, "records": records,
            "launches": want, "traces": attempt}


def _ms(x) -> str:
    return NOT_MEASURED if x is None else f"{x:.5f} ms"


def report(cell: Cell, records: list[OpRecord], steps: int, top: int,
           attempts: int = TRACE_ATTEMPTS) -> dict:
    """Print the cell's tables; return its figures."""
    on_card = cell.device.type == "cuda"
    card = roofline.card() if on_card else None
    cost = module_cost(records)
    b = cost.bound()
    where = f" on {card}" if card else " (CPU: counts only)"
    print(f"== profile_cell {cell.label}{where} ==")
    print(f"step work: {json.dumps({p: f for p, f in cost.flops.items()})} FLOP, "
          f"{cost.bytes:.4e} B (unfused); bound {b.ms:.5f} ms ({b.by})")
    bd = cost_breakdown(records, top)
    for key, title in (("by_bytes", "bytes"), ("by_flops", "FLOPs")):
        print(f"-- top {top} by {title} (bound, share of the step's bound) --")
        for lbl, c in bd[key]:
            cb = c.bound()
            print(f"  {c.bytes:12.4e} B {c.total_flops:12.4e} FLOP x{c.calls:<5d} "
                  f"{cb.ms:.6f} ms ({cb.by}) {100 * cb.ms / max(b.ms, 1e-30):5.1f}%  {lbl[:100]}")
    gn_work = kernel_work(records)
    groups = {g: OpCost() for g in KERNELS}
    for name, c in gn_work.items():
        for g, (names, _, _) in KERNELS.items():
            if name in names:
                groups[g].add(c)
    out = {"label": cell.label, "card": str(card) if card else None,
           "step_flops": cost.flops, "step_bytes": cost.bytes, "step_bound_ms": b.ms,
           "step_bound_by": b.by, "gn": {}}
    window = traced_window(cell, steps, attempts) if on_card else None
    if window:
        busy_us = sum(us for us, _ in window["kernels"].values())
        device_ms = busy_us / 1e3 / steps
        wall_ms = window["wall_s"] * 1e3 / steps
        print(f"-- top {top} device kernels over {steps} steps (ms a step, share of device "
              f"time; trace {window['traces']}) --")
        for k, (us, n) in sorted(window["kernels"].items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"  {us / 1e3 / steps:.5f} ms {100 * us / max(busy_us, 1e-30):5.1f}% "
                  f"x{n / steps:g}  {k[:100]}")
    else:
        device_ms = wall_ms = None
    print("-- GN kernels: device time a step beside their work() bound --")
    for g, c in groups.items():
        if not c.calls:
            continue
        gb = c.bound()
        ms = None
        if window:
            ms = sum(us for k, (us, _) in window["kernels"].items()
                     if kernel_group(k) == g) / 1e3 / steps
        share = f"{100 * gb.ms / ms:.1f}%" if ms else NOT_MEASURED
        print(f"  {g:20s} {c.calls} calls, device {_ms(ms)}, bound {gb.ms:.6f} ms ({gb.by}), "
              f"roofline share {share}")
        out["gn"][g] = {"calls": c.calls, "device_ms": ms, "bound_ms": gb.ms, "bound_by": gb.by}
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else None
    print(f"step: bound {b.ms:.5f} ms ({b.by}), device {_ms(device_ms)}, wall {_ms(wall_ms)}"
          + (f", roofline share of the device time {100 * b.ms / device_ms:.1f}%"
             if device_ms else "")
          + f"; max_memory_allocated {NOT_MEASURED if peak is None else f'{peak / 1e9:.3f} GB'}")
    out.update(device_ms=device_ms, wall_ms=wall_ms, max_memory_allocated=peak,
               window=window)
    return out


# ------------------------------------------------------------------ cells --
def continuous_cell(model, params, device, *, kv_dtype: str = "fp", slots: int = 8,
                    chunk: int = 16, block: int = 16, requests: int = 16,
                    prompt: tuple = (32, 1024), new: int = 32, seed: int = 0):
    """Phase 4's workload: the engine after one run (its graphs captured),
    and the tick the steady window starts at."""
    reqs = seeded_requests(model.cfg.vocab, requests, prompt[0], prompt[1], new, 1, seed)
    engine = ContinuousEngine(model, params, num_slots=slots, max_seq=required_max_seq(reqs),
                              chunk=chunk, block_size=block, kv_dtype=kv_dtype, device=device)
    engine.run(reqs)
    return engine, reqs


def engine_cell(label: str, engine, reqs, steps: int) -> Cell:
    """A steady window from the middle of the engine's run: ``rewind``
    resets the engine and runs to its start, ``step`` takes the next tick
    eagerly, ``window`` runs the ticks from there as replays."""
    start = max(0, (engine.model_ticks - steps) // 2)

    def rewind():
        engine.reset()
        for r in reqs:
            engine.submit(r)
        while engine.model_ticks < start and engine.step():
            pass

    def step():
        graphs, engine.shards[0]._graphs = engine.shards[0]._graphs, None
        try:
            return engine.step()
        finally:
            engine.shards[0]._graphs = graphs

    def window(n):
        end = engine.model_ticks + n
        while engine.model_ticks < end and engine.step():
            pass

    return Cell(label, step, window, engine.device, rewind)


def static_cell(label: str, model, params, device, batch: int, prompt: int, new: int) -> Cell:
    """The static path's decode step over a (batch, prompt + new) cache."""
    data = DataConfig(vocab=model.cfg.vocab, seq_len=prompt, global_batch=batch, seed=0)
    tokens = torch.as_tensor(batch_at(data, 0)["tokens"], device=device)
    dec = static_decoder(model, params, batch, prompt + new, device)
    model.prefill(params, {"tokens": tokens}, prompt + new, cache=dec.cache)
    token = tokens[:, -1:].to(torch.int32)
    dec(token, prompt)  # capture on the card

    def window(n):
        for i in range(n):
            dec(token, prompt + i % new)

    return Cell(label, lambda: dec._step(), window, device)


def train_cell(label: str, model, device, batch: int, seq: int, microbatches: int) -> Cell:
    """Training steps over one batch (eager; training is not graphed)."""
    params = model.init(0, device)
    opt_cfg = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    state = {"params": params, "opt": init_opt_state(opt_cfg, params)}
    train_step = make_train_step(model, opt_cfg, microbatches)
    data = batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=seq, global_batch=batch, seed=0), 0)

    def step():
        state["params"], state["opt"], _ = train_step(state["params"], state["opt"], data)

    def window(n):
        for _ in range(n):
            step()

    step()  # warm: the kernels built, the allocator sized
    return Cell(label, step, window, device)


def build_cell(args) -> Cell:
    device = resolve_device(args.device)
    set_matmul_precision()
    cfg = get_config(args.arch)
    over = {"n_layers": args.layers} if args.layers else {}
    cfg = reduce_config(cfg, **over) if args.smoke else (
        dataclasses.replace(cfg, **over) if over else cfg)
    model = make_model(cfg)
    label = f"{cfg.name} {args.path} ({cfg.n_layers} layers" + (
        f", {args.kv_dtype} KV)" if args.path == "continuous" else ")")
    small = args.smoke or device.type == "cpu"
    if args.path == "train":
        return train_cell(label, model, device, 2 if small else 4, 64 if small else 1024,
                          1 if small else 2)
    params = model.init(0, device)
    if args.path == "static":
        return static_cell(label, model, model.prepare(params, device), device, 2 if small else 8,
                           32 if small else 1024, 8 if small else 32)
    kw = dict(slots=2, chunk=4, block=4, requests=4, prompt=(8, 40), new=6) if small else {}
    attention.FORCE_PAGED_READ = None if args.read == "kernel" else args.read
    engine, reqs = continuous_cell(model, params, device, kv_dtype=args.kv_dtype,
                                   **kw)
    return engine_cell(f"{label[:-1]}, {engine.read_path} read)", engine, reqs, args.steps)


def profile(cell: Cell, steps: int, top: int, attempts: int = TRACE_ATTEMPTS) -> dict:
    """One eager step recorded and costed, then (on the card) the profiled
    window: ``report``'s figures, its ``window`` (the trace) included."""
    cell.rewind()
    _, records = record(cell.step, keep_alive=False)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    return report(cell, records, steps, top, attempts)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--path", default="continuous", choices=("continuous", "static", "train"))
    ap.add_argument("--kv-dtype", default="fp", choices=("fp", "int8"))
    ap.add_argument("--read", default="kernel", choices=attention.READ_PATHS,
                    help="the continuous path's paged read (FORCE_PAGED_READ)")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--steps", type=int, default=16, help="steps in the profiled window")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    prev = attention.FORCE_PAGED_READ  # build_cell forces --read for the whole run
    try:
        out = profile(build_cell(args), args.steps, args.top)
    finally:
        attention.FORCE_PAGED_READ = prev
    out.pop("window", None)
    return out


if __name__ == "__main__":
    main()
