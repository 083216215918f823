#!/usr/bin/env python3
"""One device's MoE engine on the kernel read beside the same engine on the
streamed read, tick by tick: chip_smoke.py phase 25's MoE case
(llama4-scout-17b-a16e at 4 layers, f32, two slots, SHARD_MOE's requests).

    python3 moe_reads_dump.py [--device cuda] [--reduced] [--out PATH]

Both engines tick eagerly from one reset through the same requests.  For
each tick and each engine it keeps the step kind and horizon bucket, the
inputs the model receives (tokens after the decode lanes' sampling,
positions, n_valid, tables), the held logits before the tick (each slot's
argmax and top-2 gap), layer 0's attention input and output for every
lane, the layer-0 arena rows that slot 0's table row addresses below its
length, and every MoE layer's routing of every lane (router logits, top-k
experts, which choices are kept).  It prints one JSON line a tick naming
what differs between the two engines (live lanes: ``lane < n_valid``; dead
lanes apart), then one summary line: the first tick at which each of those
differs.  ``--reduced`` runs ``reduce_config`` of the arch (a CPU check of
the script itself).  Without ``--device cpu`` it needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.registry import get_config, reduce_config  # noqa: E402
from repro_torch.models import attention as attention_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.transformer import make_model  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine  # noqa: E402
from repro_torch.serve.workload import required_max_seq, seeded_requests  # noqa: E402

READS = ("kernel", "streamed")


class Recorder:
    """Patches the model's paged tick, the paged attention of layer 0 and
    ``moe.route`` so that one tick's inputs, layer 0's attention and every
    layer's routing land in ``self.tick``."""

    def __init__(self, model):
        self.model, self.tick = model, None
        self.saved = (model.fused_step_slots_paged, attention_mod.attn_paged_chunk,
                      moe_mod.route)
        tick_fn, attn_fn, route_fn = self.saved

        def tick(params, cache, tokens, positions, n_valid, tables, **kw):
            self.tick.update(tokens=tokens.cpu(), positions=positions.cpu(),
                             n_valid=n_valid.cpu(), tables=tables.cpu(), layer=0)
            return tick_fn(params, cache, tokens, positions, n_valid, tables, **kw)

        def attn(cfg, p, arena_k, arena_v, x, positions, n_valid, tables, *args, **kw):
            out = attn_fn(cfg, p, arena_k, arena_v, x, positions, n_valid, tables, *args, **kw)
            if self.tick["layer"] == 0:
                y = out[0] if isinstance(out, tuple) else out
                bs = arena_k.shape[1]
                length = int(positions[0]) + int(n_valid[0])
                blocks = tables[0, : -(-length // bs)].long()
                rows = lambda a: a[blocks].reshape(-1, *a.shape[2:])[:length].cpu()  # noqa: E731
                self.tick.update(x0=x.cpu(), y0=y.cpu(), arena_k0=rows(arena_k),
                                 arena_v0=rows(arena_v))
            self.tick["layer"] += 1
            return out

        def route(*args, **kw):
            r = route_fn(*args, **kw)
            self.tick.setdefault("routes", []).append(
                tuple(r[k].flatten(0, 1).cpu() for k in ("logits", "idx", "keep")))
            return r

        model.fused_step_slots_paged = tick
        attention_mod.attn_paged_chunk = attn
        moe_mod.route = route


def rel(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    scale = float(a.abs().max()) or 1.0
    return float((a.double() - b.double()).abs().max()) / scale


def compare(t: int, a: dict, b: dict, slots: int) -> dict:
    """What differs between the two engines' records of tick ``t``."""
    out = {"tick": t, "kind": (a["kind"], b["kind"]), "bucket": (a["bucket"], b["bucket"])}
    for k in ("tokens", "positions", "n_valid", "tables"):
        out[f"{k}_equal"] = bool(torch.equal(a[k], b[k]))
    out["tokens"] = {r: a["tokens"][:, 0].tolist() for r, a in (("kernel", a), ("streamed", b))}
    out["tokens"]["streamed"] = b["tokens"][:, 0].tolist()
    out["positions"] = a["positions"].tolist()
    out["n_valid"] = a["n_valid"].tolist()
    out["held_argmax"] = (a["held"].argmax(-1).tolist(), b["held"].argmax(-1).tolist())
    top2 = a["held"].topk(2, dim=-1).values
    out["held_top2_gap"] = (top2[:, 0] - top2[:, 1]).tolist()
    out["held_rel_diff"] = [rel(a["held"][s], b["held"][s]) for s in range(slots)]
    c = a["tokens"].shape[1]
    live = torch.arange(c)[None, :] < a["n_valid"][:, None]  # (N, C)
    same_in = all(out[f"{k}_equal"] for k in ("tokens", "positions", "n_valid", "tables"))
    if "x0" in a and "x0" in b:
        out["x0_live_rel"] = rel(a["x0"][live], b["x0"][live])
        out["y0_live_rel"] = rel(a["y0"][live], b["y0"][live])
        out["y0_dead_rel"] = rel(a["y0"][~live], b["y0"][~live]) if (~live).any() else 0.0
        out["y0_dead_finite"] = (bool(torch.isfinite(a["y0"][~live]).all()),
                                 bool(torch.isfinite(b["y0"][~live]).all()))
        if a["arena_k0"].shape == b["arena_k0"].shape:
            out["arena0_slot0_rel"] = max(rel(a["arena_k0"], b["arena_k0"]),
                                          rel(a["arena_v0"], b["arena_v0"]))
        else:
            out["arena0_slot0_rel"] = f"rows {a['arena_k0'].shape[0]} vs {b['arena_k0'].shape[0]}"
    flat_live = live.reshape(-1)
    layers = []
    for la, lb in zip(a.get("routes", []), b.get("routes", [])):
        lo_a, lo_b = la[0], lb[0]
        if lo_a.shape[0] != flat_live.shape[0]:  # a tick kind whose tokens the mask misses
            layers.append({"rows": int(lo_a.shape[0])})
            continue
        idx_moved = (la[1] != lb[1]).any(-1)
        keep_moved = (la[2] != lb[2]).any(-1)
        layers.append({
            "live_logits_rel": rel(lo_a[flat_live], lo_b[flat_live]),
            "live_idx_moved": int((idx_moved & flat_live).sum()),
            "live_keep_moved": int((keep_moved & flat_live).sum()),
            "live_dropped": (int((~la[2][flat_live]).sum()), int((~lb[2][flat_live]).sum())),
            "dead_idx_moved": int((idx_moved & ~flat_live).sum()),
            "dead_keep_moved": int((keep_moved & ~flat_live).sum()),
            "dead_logits_rel": rel(lo_a[~flat_live], lo_b[~flat_live]) if (~flat_live).any()
            else 0.0})
    out["layers"] = layers
    out["inputs_equal"] = same_in
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("moe_reads_dump: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(cs.MOE_ARCH)
    cfg = reduce_config(cfg) if args.reduced else cfg
    cfg = dataclasses.replace(cfg, n_layers=cs.MOE_LAYERS, dtype="float32")
    model = make_model(cfg)
    master = model.init(cs.SEED, args.device)
    n, lo, hi, new = cs.SHARD_MOE
    reqs = seeded_requests(cfg.vocab, n, lo, hi, new, 1, cs.SEED)
    kw = {"num_slots": cs.SHARDS, "max_seq": required_max_seq(reqs), "chunk": cs.CHUNK,
          "block_size": cs.BLOCK}
    engines = {}
    for read in READS:
        with cs.swapped("FORCE_PAGED_READ", None if read == "kernel" else read):
            engines[read] = ContinuousEngine(model, master, device=args.device, **kw)
        engines[read].shards[0]._graphs = None  # eager: every op dispatched, so recorded
        for r in reqs:
            engines[read].submit(r)
    rec = Recorder(model)
    lines, first = [], {}
    going = True
    while going:
        ticks = {}
        for read in READS:
            e = engines[read]
            rec.tick = {"held": e.held_logits().float().cpu().clone()}
            with cs.swapped("FORCE_PAGED_READ", None if read == "kernel" else read):
                going = e.step() and going
            rec.tick["kind"] = "fused" if e.phase_log and e.phase_log[-1][0] else "decode"
            rec.tick["bucket"] = e.horizon_log[-1][1] if e.horizon_log else None
            ticks[read] = rec.tick
        if "tokens" not in ticks["kernel"] or "tokens" not in ticks["streamed"]:
            break
        line = compare(engines["kernel"].model_ticks, ticks["kernel"], ticks["streamed"],
                       cs.SHARDS)
        lines.append(line)
        print(json.dumps(line), flush=True)
        checks = {"inputs": not line["inputs_equal"],
                  "held_argmax": line["held_argmax"][0] != line["held_argmax"][1],
                  "live_keep": any(la.get("live_keep_moved", 0) for la in line["layers"]),
                  "live_idx": any(la.get("live_idx_moved", 0) for la in line["layers"]),
                  "dead_route": any(la.get("dead_idx_moved", 0) or la.get("dead_keep_moved", 0)
                                    for la in line["layers"]),
                  "y0_dead": bool(line.get("y0_dead_rel", 0.0))}
        for k, hit in checks.items():
            if hit and k not in first:
                first[k] = line["tick"]
    toks = {read: {c.request_id: list(map(int, c.new_tokens)) for c in e.completions}
            for read, e in engines.items()}
    summary = {"arch": cfg.name, "layers": cfg.n_layers, "device": args.device,
               "ticks": len(lines), "first_tick_differing": first,
               "requests_equal": sum(toks["kernel"].get(i) == t
                                     for i, t in toks["streamed"].items()),
               "requests": len(toks["streamed"]), "tokens": toks}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"ticks": lines, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
