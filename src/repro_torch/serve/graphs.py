"""CUDA-graph capture and replay of the serving steps: the port's
counterpart of the reference's ``CountingJit`` (``repro/serve/engine.py``).

The reference traces each tick once per (step kind, horizon bucket) and
runs the compiled program after.  Here a step is a function of no
arguments that reads and writes only tensors that outlive it (the engine's
static buffers, the pool's arenas, the weights), so a ``torch.cuda.CUDAGraph``
captured from one call replays every later call of the same key: the
step's ~900 launches leave the host once per key instead of once per step.

``StepGraphs.run(key, fn, warmup)``:
  * the first time ``key`` is seen: run ``warmup`` on a side stream (a call
    of the step that changes no state the caller reads: it builds the
    kernels and fills the lazily made tensors, the LUTs among them, which a
    capture cannot make), then capture ``fn`` into a graph that shares the
    runner's memory pool with every other graph of the runner (they replay
    one after another on one stream);
  * then, and on every later call: replay the graph and return the tensors
    ``fn`` returned at capture, which each replay overwrites.
A capture or a replay that fails raises; nothing falls back to eager.

A runner belongs to one device: its memory pool handle, its side stream,
and every warm-up, capture and replay are taken with that device current
(``kernels._build.on_device``), so the shards of a sharded engine, one
runner each, capture and replay on their own cards whichever device the
caller left current.

No Python garbage collection runs during a capture: a collection there may
free a graph held by a dead reference cycle (an engine whose prefix cache
points back at its pool, a model holding its static decoders), and
destroying a graph while another stream is capturing invalidates that
capture.  Dead graphs are freed at the next collection after it.

Launch counting: the kernels' wrappers count in Python, at capture and not
at replay.  The runner keeps what a capture counted and adds it on every
replay, and drops what the warm-up and the capture itself counted (the
warm-up is set-up, as the launches that hold a kernel against its plain
version are), so ``kernels.counters`` keeps counting the launches the card
executed on the path.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Hashable

import torch

from repro_torch.kernels import _build, counters


class StepGraphs:
    """Graphs of one caller's steps, keyed by a tuple whose first element
    names the step kind (``captures`` counts per kind)."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        with _build.on_device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(device)
        self._graphs: dict[Hashable, tuple] = {}
        self.captures: dict[str, int] = {}
        self.capture_seconds = 0.0  # host time of warm-ups and captures

    def run(self, key: tuple, fn: Callable, warmup: Callable):
        """Replay ``key``'s graph (captured from ``fn`` first if new) and
        return ``fn``'s static outputs."""
        with _build.on_device(self.device):
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(fn, warmup)
                self.captures[key[0]] = self.captures.get(key[0], 0) + 1
            graph, out, per_replay = entry
            graph.replay()
        counters.add(per_replay)
        return out

    def _capture(self, fn: Callable, warmup: Callable) -> tuple:
        t0 = time.perf_counter()
        start = counters.snapshot()
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            warmup()
        main.wait_stream(self._side)
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        after = counters.snapshot()
        counters.add([s - a for s, a in zip(start, after)])
        self.capture_seconds += time.perf_counter() - t0
        return graph, out, [a - b for a, b in zip(after, before)]
