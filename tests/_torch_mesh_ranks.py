"""Rank bodies of the sharded-training tests (``test_torch_mesh.py``), run
in processes that ``launch._host_devices.run_ranks`` spawns over gloo.  A
module of its own, importing only torch and the port, so that each rank
imports neither JAX nor the reference.

Each body returns what rank 0 saw; every rank runs every collective.
"""
import contextlib
import dataclasses
from pathlib import Path

import torch

from repro_torch.configs.registry import get_config, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import make_model
from repro_torch.parallel.sharding import distribute_params, use_sharding
from repro_torch.train.loop import _sharded_batch
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

ARCHS = ("internlm2-1.8b", "mixtral-8x22b")
# families whose mixers run whole on local shards (``local_mixer``): MLA's
# (its rows alone), whisper's and the VLM's cross-attention (its rows and the
# memory's), the mLSTM (xlstm) and zamba2's Mamba2 and shared attention
MIXER_ARCHS = ("minicpm3-4b", "whisper-large-v3", "llama-3.2-vision-11b", "xlstm-350m",
               "zamba2-7b")
SEQ, BATCH = 16, 8


@contextlib.contextmanager
def f32_launcher():
    """``launch.train`` on the reduced configs at f32 (the tests hold its
    losses to other runs')."""
    saved = train_launch.reduce_config
    train_launch.reduce_config = lambda cfg: reduce_config(cfg, dtype="float32")
    try:
        yield
    finally:
        train_launch.reduce_config = saved


def launcher_args(arch: str, outdir, steps: int, mesh: str | None = None) -> list:
    """``launch.train`` over reduced ``arch`` (at f32 under ``f32_launcher``),
    ``steps`` steps, one checkpoint at the end."""
    return (["--arch", arch, "--smoke", "--device", "cpu", "--seq",
             str(SEQ), "--batch", str(BATCH), "--steps", str(steps), "--checkpoint-every", "10",
             "--outdir", str(outdir)] + (["--mesh", mesh] if mesh else []))


def _forward_gap(arch: str, shape: tuple, dtype: str = "float32") -> float:
    """max |sharded logits - one device's| of batch 0 over a ``shape`` mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    model = make_model(cfg)
    params = model.init(0, "cpu")
    batch = _batch(cfg)
    want = model.forward(model.prepare(params, "cpu"), batch).float()
    with use_sharding(make_test_mesh(shape)), implicit_replication():
        got = model.forward(model.prepare(distribute_params(model, params), "cpu"),
                            _sharded_batch(batch)).full_tensor().float()
    return float((got - want).abs().max())


def _batch(cfg) -> dict:
    """Batch 0 of the launcher's data, with seeded frames (encdec) or
    patches (VLM)."""
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=1234)
    batch = {k: torch.as_tensor(v) for k, v in batch_at(data, 0).items()}
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(BATCH, cfg.encoder_seq, cfg.d_model, generator=gen)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(BATCH, cfg.num_patches, cfg.d_model, generator=gen)
    return batch


def _grad_gap(arch: str, shape: tuple) -> float:
    """The largest relative L2 gap of a step-1 gradient leaf (f32) between
    the ``shape`` mesh and one device, each leaf gathered whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype="float32")
    model = make_model(cfg)
    params = model.init(0, "cpu")
    batch = _batch(cfg)

    def grads(ps, b):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), ps)
        loss, _ = model.loss(model.prepare(leaves, "cpu"), b)
        return torch.autograd.grad(loss, tree_leaves(leaves))

    want = grads(params, batch)
    with use_sharding(make_test_mesh(shape)), implicit_replication():
        got = [g.full_tensor() for g in grads(distribute_params(model, params),
                                              _sharded_batch(batch))]
    return max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(got, want))


def train_and_remesh(rank: int, world: int, root: str) -> dict:
    """For each arch: the sharded forward's gap to one device's on a (2, 2)
    mesh, then ``launch.train --mesh 2x2`` for 4 steps and, from its step-4
    checkpoint, ``--mesh 4x1`` for step 5 (``store.restore_sharded`` onto
    another mesh); for each of the other families the step-1 gradients'
    gap to one device's on (2, 2)."""
    out = {arch: {"grad_gap": _grad_gap(arch, (2, 2))} for arch in MIXER_ARCHS}
    for arch in ARCHS:
        outdir = Path(root) / arch
        with f32_launcher():
            out[arch] = {"forward_gap": _forward_gap(arch, (2, 2)),
                         "final_2x2": train_launch.main(launcher_args(arch, outdir, 4, "2x2")),
                         "final_4x1": train_launch.main(launcher_args(arch, outdir, 5, "4x1"))}
    return out


def elastic_check(rank: int, world: int, arch: str, root: str) -> dict:
    """The reference's ``tests/distributed_check.py`` over 8 ranks: on a
    (2, 4) mesh the sharded forward against one device's (at the config's
    dtype), 4 sharded steps, a checkpoint; restored onto (4, 2), one more
    step."""
    from repro_torch.checkpoint import store
    from repro_torch.train.loop import make_train_step

    cfg = reduce_config(get_config(arch))
    model = make_model(cfg)
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    gap = _forward_gap(arch, (2, 4), cfg.dtype)
    step_fn = make_train_step(model, opt_cfg)
    with use_sharding(make_test_mesh((2, 4))):
        p = distribute_params(model, model.init(0, "cpu"))
        o = init_opt_state(opt_cfg, p)
        losses = []
        for i in range(4):
            p, o, m = step_fn(p, o, batch_at(data, i))
            losses.append(float(m["loss"]))
        store.save(Path(root) / "ckpt", 4, (p, o))
    with use_sharding(make_test_mesh((4, 2))):
        like = distribute_params(model, model.init(0, "cpu"))
        like = (like, init_opt_state(opt_cfg, like))
        (p2, o2), man = store.restore_sharded(Path(root) / "ckpt", 4, like)
        placed = [p2["layers"]["mixer"]["wq"].placements,
                  o2["m"]["layers"]["mixer"]["wq"].placements]
        p2, o2, m2 = step_fn(p2, o2, batch_at(data, 4))
    return {"forward_gap": gap, "losses": losses, "step5": float(m2["loss"]),
            "step": man["step"], "placed": [str(x) for x in placed]}
