"""Training entry point of the port: fault-tolerant AdamW training of any
registered GN (or exact) model, the SSM and hybrid families among them (port
of ``repro/launch/train.py``).

  * checkpoints every ``--checkpoint-every`` steps and at the end
    (``checkpoint/store.py``, atomic, the reference's format), and resumes
    from the latest one;
  * step-keyed data (``batch_at(data, step)``), so a resumed run replays the
    uninterrupted one: bit for bit on the CPU; on the card the embedding's
    backward sums with atomics, so a resumed run may part in the last bits;
  * ``--fail-at N`` (or REPRO_FAIL_AT_STEP) kills the process with exit code
    42 right after step N, as a lost node would die;
  * a straggler watchdog: a step slower than ``--straggler-factor`` times
    the median of the last 20 is logged as one;
  * ``train_log.jsonl`` under ``--outdir``, one line a step;
  * ``--grad-compression BITS``: int8 (or other width) error-feedback
    compression of the gradients before the update.

Runs on CUDA unless ``--device cpu`` is given.  ``--mesh`` is refused (the
port serves and trains on one device; multi-GPU waits, ROADMAP Queue A 8).
A ``--seq`` past 2048 tokens trains as the reference's chunked path does:
the GN flash kernel's backward takes the straight-through exponential
there (``kernels/gn_attention/ops.py``), the exact softmax streams.

Usage:
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke --steps 20 --device cpu
  python -m repro_torch.launch.train --arch xlstm-350m --smoke --steps 20
  python -m repro_torch.launch.train --arch zamba2-7b --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get_config, list_archs, reduce_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.launch.serve import set_matmul_precision
from repro_torch.models.transformer import make_model
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU tests)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--outdir", default="runs/default")
    ap.add_argument("--fail-at", type=int, default=int(os.environ.get("REPRO_FAIL_AT_STEP", -1)))
    ap.add_argument("--mesh", default=None, help="refused: one device")
    ap.add_argument("--grad-compression", type=int, default=None)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None, help="default: cuda, raising without a GPU")
    return ap


def main(argv=None) -> float:
    """Train, checkpoint and log; returns the final step's loss."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: the port trains on one device; multi-GPU is not "
                                  "ported yet (ROADMAP Queue A 8)")
    device = resolve_device(args.device)
    set_matmul_precision()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    model = make_model(cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=1234)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps,
                              grad_compression=args.grad_compression)
    outdir = Path(args.outdir)
    ckpt_dir = outdir / "ckpt"
    outdir.mkdir(parents=True, exist_ok=True)

    params = model.init(0, device)
    opt_state = init_opt_state(opt_cfg, params)
    start = 0
    latest = store.latest_step(ckpt_dir)
    if latest is not None:
        (params, opt_state), man = store.restore(ckpt_dir, latest, (params, opt_state))
        start = man["step"]
        print(f"[resume] from checkpoint step {start}", flush=True)

    train_step = make_train_step(model, opt_cfg)
    times: list[float] = []
    metrics = None
    with open(outdir / "train_log.jsonl", "a") as log:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch_at(data_cfg, step))
            loss = float(metrics["loss"])  # the step's one device->host copy
            dt = time.perf_counter() - t0
            times.append(dt)
            med = statistics.median(times[-20:])
            straggler = len(times) > 3 and dt > args.straggler_factor * med
            rec = {"step": step + 1, "loss": loss, "sec": round(dt, 4),
                   "straggler": bool(straggler)}
            log.write(json.dumps(rec) + "\n")
            log.flush()
            print(f"step {step + 1:5d} loss {loss:.4f} {dt * 1e3:7.1f}ms"
                  + ("  [STRAGGLER]" if straggler else ""), flush=True)
            if (step + 1) % args.checkpoint_every == 0 or step + 1 == args.steps:
                store.save(ckpt_dir, step + 1, (params, opt_state), extra={"arch": cfg.name})
            if args.fail_at == step + 1:
                print(f"[failure-injection] dying at step {step + 1}", flush=True)
                os._exit(42)  # a hard kill, no cleanup, as a lost node
    if metrics is None:
        raise ValueError(f"nothing to train: the checkpoint is at step {start} of {args.steps}")
    final = float(metrics["loss"])
    print(f"[done] final loss {final:.4f}")
    return final


if __name__ == "__main__":
    main()
