"""Multi-pod dry run: record one device's program of every (arch x shape x
mesh) cell over fake tensors (port of ``repro/launch/dryrun.py``).

For each cell this shows, without a card and without a cluster:
  * the sharding is coherent: the train step, the prefill or the decode
    step runs over DTensors on the production mesh (``launch/mesh.py``'s
    (16, 16) or (2, 16, 16)) and every op propagates;
  * each device's program fits: the bytes of its arguments, its outputs
    and its temporaries (``memory``), beside the card's 80 GB;
  * the roofline's three terms (``roofline.analysis.analyze``), with the
    bytes each device moves in collectives by kind.

The reference AOT-lowers and compiles each cell over 512 forced host
devices.  The port has no compiler: the mesh lives in a fake process group
of as many ranks (``launch/fake_group.py``), rank 0 being this process,
and every tensor is a ``FakeTensor`` (shapes, dtypes and a device, no
memory).  Parameters, optimizer state and inputs are DTensors whose local
shards have the shapes ``parallel.sharding.ShardingCtx.placements`` gives
(``DTensor.from_local``, no scatter).  One call of the cell's entry point
then runs under a ``FakeTensorMode`` that records each local op
(``analysis.op_walk``: each GN kernel wrapper one opaque record with its
``work()``, through the wrappers' shape-only route, so nothing launches)
and meters the bytes of the fake storages alive at each op.

Memory, per device (the reference's keys): ``argument_bytes`` the local
shards of the parameters (f32 masters), the AdamW state (train) and the
inputs; ``output_bytes`` the storages the call returns; ``temp_bytes`` the
peak of the bytes the call allocated and held at once, less those its
outputs keep.  The program is the port's eager one: no fusion, no
rematerialisation, every saved activation alive until the backward.

Each cell's JSON goes to ``--outdir`` (``experiments/dryrun_torch``), as
the reference's schema (``arch``, ``shape``, ``mesh``, ``ok``, ``lower_s``
(here: the recorded call's seconds), ``memory``, ``collective_bytes``,
``roofline``; ``error`` and ``traceback`` on a failure).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod both|single|multi]

Nothing touches a device: ``--device`` (``cpu``, or ``cuda`` on a machine
with a card) only names the fake tensors' device, so each kernel wrapper's
route for it is the one costed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ShapeConfig, shapes_for_arch
from repro_torch.configs.registry import (ASSIGNED_ARCHS, get_config, input_logical_axes,
                                          input_specs)
from repro_torch.parallel.sharding import is_dtensor, zeros

CARD_BYTES = 80e9  # one H100's HBM
MESHES = {False: "pod16x16", True: "pod2x16x16"}


def fake_dtensor(shape, dtype, axes, device):
    """A DTensor of global ``shape`` over a fake local shard (under the
    recording mode), placed by the installed context's rules for the
    logical ``axes`` (``sharding.zeros``)."""
    return zeros(tuple(shape), dtype, device, tuple(axes))


def local_bytes(tree) -> int:
    """Bytes of the local shards (or plain tensors) of a tree's leaves."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def fake_params(model, device) -> dict:
    """f32 masters of ``model.param_specs()`` as fake DTensors."""
    from repro_torch.models.layers import ParamSpec

    def walk(s):
        if isinstance(s, ParamSpec):
            return fake_dtensor(s.shape, torch.float32, s.logical_axes, device)
        return {k: walk(v) for k, v in s.items()}

    return walk(model.param_specs())


def fake_inputs(cfg, shape: ShapeConfig, device, sharded: bool = True) -> dict:
    """``input_specs`` as fake tensors, each a DTensor placed by
    ``input_logical_axes`` when ``sharded`` (the prefill's and the decode
    step's inputs), else whole on each device (the train step takes the
    global batch and places each microbatch itself, ``train.loop``)."""
    specs, axes = input_specs(cfg, shape), input_logical_axes(cfg, shape)

    def one(spec, ax):
        if isinstance(spec, dict):
            return {k: one(spec[k], ax[k]) for k in spec}
        s, dt = spec
        if not sharded or not s:
            return torch.empty(s, dtype=dt, device=device)
        return fake_dtensor(s, dt, ax, device)

    return {k: one(specs[k], axes[k]) for k in specs}


class Meter:
    """Bytes of the fake storages created while it is on, alive at each op:
    the running total, its peak, and each storage's weak reference (a
    storage shared by views counts once)."""

    def __init__(self):
        self.live: dict[int, tuple] = {}
        self.now = self.peak = 0
        self.on = False

    def sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.now -= self.live.pop(k)[1]

    def add(self, out) -> None:
        self.sweep()
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if s._cdata not in self.live:
                self.live[s._cdata] = (StorageWeakRef(s), s.nbytes())
                self.now += s.nbytes()
        self.peak = max(self.peak, self.now)

    def held_by(self, tree) -> int:
        """Bytes of the metered storages that ``tree``'s tensors hold."""
        keys = set()
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if is_dtensor(t) else t
                keys.add(t.untyped_storage()._cdata)
        return sum(self.live[k][1] for k in keys if k in self.live)


def recording_mode(recorder, meter):
    """A ``FakeTensorMode`` that hands each outermost op it runs on fake
    tensors, with a tensor result, to ``recorder.note`` and its outputs to
    ``meter``, while the meter is on.  Under DTensor those are the local ops
    and the c10d collectives of rank 0: a DTensor op reaches the mode first,
    is declined, and DTensor's own dispatch then runs the local ops.  The
    ops DTensor runs on global-shape fakes to learn an output's shape
    (``ShardingPropagator._propagate_tensor_meta_non_cached``, under the
    active fake mode) are no work of the device, and are left out
    (``quiet``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Recording(FakeTensorMode):
        depth = quiet = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.depth += 1
            try:
                out = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.depth -= 1
            if (meter.on and self.depth == 0 and not self.quiet and out is not NotImplemented
                    and any(isinstance(t, torch.Tensor) for t in tree_leaves(out))):
                meter.add(out)
                recorder.note(func, args, kwargs or {}, out)
            return out

    return Recording()


@contextlib.contextmanager
def quiet_propagation(mode):
    """DTensor's output-shape propagation unrecorded under ``mode``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    saved = getattr(ShardingPropagator, name, None)
    if saved is None:
        raise RuntimeError(f"this torch's DTensor has no ShardingPropagator.{name}: the dry run "
                           "cannot tell its shape propagation from a device's ops")

    def quiet(self, *args, **kwargs):
        mode.quiet += 1
        try:
            return saved(self, *args, **kwargs)
        finally:
            mode.quiet -= 1

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, saved)


def lower_cell(arch: str, shape: ShapeConfig, multi_pod: bool, device: str = "cpu",
               cfg=None) -> dict:
    """Record one device's call of the cell on a fake production mesh
    (``record_call``).  ``cfg`` overrides the arch's config (tests run
    reduced ones)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import SP_OVERRIDES

    dev_type = torch.device(device).type
    return record_call(cfg or get_config(arch), shape, 512 if multi_pod else 256,
                       lambda: make_production_mesh(multi_pod=multi_pod, device_type=dev_type),
                       device, SP_OVERRIDES if shape.name == "long_500k" else None)


def record_call(cfg, shape: ShapeConfig, world: int, make_mesh, device: str = "cpu",
                overrides=None, opt_cfg=None, microbatches=None, batch=None) -> dict:
    """One device's call of ``shape``'s entry point for ``cfg`` over a fake
    group of ``world`` ranks, on the mesh ``make_mesh()`` builds over it,
    under ``use_sharding(mesh, overrides)``: the train step
    (``train.loop.make_train_step`` with ``opt_cfg`` (default: AdamW with
    the config's state dtype) and ``microbatches`` (default: the
    config's)), the prefill at ``shape.seq_len``, or the decode step.
    ``batch`` (name -> (shape, dtype)) replaces the train step's
    ``input_specs``.  Returns the records, ``memory`` (argument, output
    and temp bytes, and the arguments by part), the mesh's device count,
    the model FLOPs (``roofline.analysis.model_flops_for``) and the
    recorded call's seconds."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.op_walk import OpRecorder
    from repro_torch.launch.fake_group import fake_group
    from repro_torch.models.transformer import make_model
    from repro_torch.parallel.sharding import use_sharding
    from repro_torch.roofline.analysis import model_flops_for
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

    recorder, meter = OpRecorder(keep_alive=False), Meter()
    with fake_group(world):
        mesh = make_mesh()
        mode = recording_mode(recorder, meter)
        with mode, quiet_propagation(mode), use_sharding(mesh, overrides), recorder.listening():
            model = make_model(cfg)
            params = fake_params(model, device)
            if batch is not None:
                inputs = {k: torch.empty(s, dtype=dt, device=device) for k, (s, dt) in batch.items()}
            else:
                inputs = fake_inputs(cfg, shape, device, sharded=shape.kind != "train")
            parts = {"params": local_bytes(params), "inputs": local_bytes(inputs)}
            if shape.kind == "train":
                opt_cfg = opt_cfg or OptimizerConfig(state_dtype=cfg.opt_state_dtype)
                state = init_opt_state(opt_cfg, params)
                parts["opt_state"] = local_bytes(state)
                step = make_train_step(model, opt_cfg, microbatches or cfg.microbatches)

                def call():
                    return step(params, state, inputs)
            elif shape.kind == "prefill":
                def call():
                    return model.prefill(model.prepare(params, device), inputs,
                                         max_seq=shape.seq_len)
            else:
                def call():
                    return model.decode_step(model.prepare(params, device), inputs["cache"],
                                             inputs["token"], inputs["pos"])
            meter.on = True
            t0 = time.perf_counter()
            with implicit_replication(), torch.set_grad_enabled(shape.kind == "train"):
                out = call()
            seconds = time.perf_counter() - t0
            meter.sweep()
            held = meter.held_by(out)
            meter.on = False
            memory = {"argument_bytes": sum(parts.values()), "output_bytes": local_bytes(out),
                      "temp_bytes": meter.peak - held, "argument_parts": parts}
            del out
    return {"records": recorder.records, "memory": memory, "n_chips": mesh.size(),
            "model_flops": model_flops_for(cfg, shape), "seconds": seconds}


def run_cell(arch: str, shape: ShapeConfig, multi_pod: bool, outdir: Path,
             device: str = "cpu", cfg=None) -> dict:
    """One cell's record, written to ``outdir/<arch>__<shape>__<mesh>.json``."""
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.op_cost import collective_bytes

    mesh_name = MESHES[multi_pod]
    cell = f"{arch}__{shape.name}__{mesh_name}"
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "ok": False,
                 "device": device}
    t0 = time.perf_counter()
    try:
        got = lower_cell(arch, shape, multi_pod, device, cfg)
        roof = analyze(got["records"], got["n_chips"], got["model_flops"])
        mem = got["memory"]
        rec.update(ok=True, lower_s=round(time.perf_counter() - t0, 2),
                   call_s=round(got["seconds"], 2), memory=mem,
                   fits=mem["argument_bytes"] + mem["temp_bytes"] <= CARD_BYTES,
                   ops=len(got["records"]),
                   collective_bytes=collective_bytes(got["records"]), roofline=roof.to_dict())
        total = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        print(f"[ok] {cell}: {rec['lower_s']:.1f}s  args+temp={total:.2f}GB of "
              f"{CARD_BYTES / 1e9:.0f}  collective={rec['collective_bytes']['total'] / 1e9:.3f}GB  "
              f"bottleneck={roof.bottleneck}  terms(c/m/coll)={roof.compute_s:.4f}/"
              f"{roof.memory_s:.4f}/{roof.collective_s:.4f}s", flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {cell}: {rec['error'][:300]}", flush=True)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{cell}.json").write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cpu",
                    help="the fake tensors' device: cpu, or cuda where a card is present")
    args = ap.parse_args(argv)

    outdir = Path(args.outdir)
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else (args.arch,)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.multi_pod]
    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes_for_arch(arch):
            if args.shape and shape.name != args.shape:
                continue
            for mp in meshes:
                path = outdir / f"{arch}__{shape.name}__{MESHES[mp]}.json"
                if args.skip_existing and path.exists():
                    with contextlib.suppress(ValueError):
                        if json.loads(path.read_text()).get("ok"):
                            n_ok += 1
                            continue
                rec = run_cell(arch, shape, mp, outdir, args.device)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"done: {n_ok} ok, {n_fail} failed in {time.perf_counter() - t0:.1f}s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
