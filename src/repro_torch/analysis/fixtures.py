"""Known-bad and known-good fixtures for the Pass A audit rules (the port's
counterpart of ``repro/analysis/fixtures.py``).

Each audit rule gets a small torch function over a synthetic paged arena
that breaks exactly its invariant, fed through the real audit machinery
(``audit_entry_point`` / ``check_trace_keys``), and a twin that passes
clean.  They back ``--self-check`` (every rule still catches its fixture)
and ``--break-invariant RULE`` (a non-zero exit naming the rule).  The
lint rules' fixtures are sources on the rules themselves (``rules.py``).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.audit import EntryPoint, audit_entry_point, check_trace_keys
from repro_torch.analysis.findings import Finding

# A synthetic pool: one layer of 8 blocks + the sink, block 4, rows of 6;
# 2 slots reading a 4-block bucket.
_L, _NB, _BS, _D = 1, 8, 4, 6
_N, _BUCKET = 2, 4


def _pool(dtype=torch.float32) -> dict:
    g = torch.Generator().manual_seed(0)
    arena = torch.randn(_L, _NB + 1, _BS, _D, generator=g)
    if dtype == torch.int8:
        return {"k": (arena * 40).round().clamp(-127, 127).to(torch.int8),
                "k_scale": torch.full((_L, _NB + 1), 0.025)}
    return {"k": arena.to(dtype)}


def _tables() -> torch.Tensor:
    return torch.arange(_N * _BUCKET, dtype=torch.int32).reshape(_N, _BUCKET)


def _gathered_read(pool, tables):
    """The whole bucketed stream in one arena gather."""
    stream = pool["k"][0][tables.long()]                 # (N, BUCKET, BS, D)
    return stream.reshape(_N, _BUCKET * _BS, _D).sum(dim=1)


def _streamed_read(pool, tables):
    """One table column at a time: no gather larger than a block a slot."""
    acc = torch.zeros(_N, _D)
    for j in range(tables.shape[1]):
        acc = acc + pool["k"][0][tables[:, j].long()].sum(dim=1)
    return acc


def _entry(name, fn, pool, *, quantized=False, gather=None, health=None):
    tables = _tables()
    return EntryPoint(name=name, call=lambda: fn(pool, tables), leaves=lambda: pool,
                      kv_leaves=("k",), gather=gather, quantized=quantized, health=health,
                      sources=lambda: [tables])


def _audit(ep) -> list[Finding]:
    return audit_entry_point(ep, f"fixture:{ep.name}")


# --------------------------------------------------------- per-rule pairs --
def _gather_bad():
    return _audit(_entry("gathered_read_as_kernel", _gathered_read, _pool(),
                         gather=(0, _L, _N * _BUCKET)))


def _gather_good():
    return _audit(_entry("streamed_read", _streamed_read, _pool(), gather=(0, _L, _N * _BUCKET)))


def _donate_bad():
    def tick(pool, tables):  # the leaf rebound to a new tensor: the graph reads the old one
        pool["k"] = pool["k"] + 1.0
        return tables
    return _audit(_entry("leaf_rebound", tick, _pool()))


def _donate_good():
    def tick(pool, tables):
        pool["k"].add_(1.0)
        return tables
    return _audit(_entry("leaf_in_place", tick, _pool()))


def _f64_bad():
    def tick(pool, tables):
        return (_streamed_read(pool, tables).double().cumsum(dim=1) * 2.0).float()
    return _audit(_entry("f64_tick", tick, _pool()))


def _f64_good():
    def tick(pool, tables):
        return _streamed_read(pool, tables).cumsum(dim=1) * 2.0
    return _audit(_entry("f32_tick", tick, _pool()))


def _transfer_bad():
    def tick(pool, tables):
        s = _streamed_read(pool, tables)
        return s * 2.0 if s.sum().item() > 0 else s  # a host sync in the body
    return _audit(_entry("sync_in_tick", tick, _pool()))


def _transfer_good():
    def tick(pool, tables):
        s = _streamed_read(pool, tables)
        return torch.where(s.sum() > 0, s * 2.0, s)
    return _audit(_entry("pure_tick", tick, _pool()))


def _metrics(fused_buckets, decode_buckets, grid, extra_fused=0):
    return {"horizon_bucket_grid": list(grid), "fused_buckets": list(fused_buckets),
            "decode_buckets": list(decode_buckets),
            "fused_step_compilations": len(fused_buckets) + extra_fused,
            "decode_compilations": len(decode_buckets), "prefill_compilations": 0,
            "fused_ticks": 1, "model_ticks": 2, "kv_paged": True}


def _tracekey_bad():
    # one more fused capture than buckets seen: a key captured twice
    return check_trace_keys(_metrics([1, 2], [1], grid=[1, 2, 4], extra_fused=1),
                            "fixture:tracekey_extra_capture", paged=True, captures=True,
                            max_seq=16, block_size=4, engine_grid=[1, 2, 4])


def _tracekey_good():
    return check_trace_keys(_metrics([1, 2], [1], grid=[1, 2, 4]), "fixture:tracekey_exact",
                            paged=True, captures=True, max_seq=16, block_size=4,
                            engine_grid=[1, 2, 4])


def _quant_bad():
    def tick(pool, tables):  # the whole int8 arena dequantized, then read
        fp = pool["k"].float() * pool["k_scale"][:, :, None, None]
        return fp[0][tables.long()].sum(dim=(1, 2))
    return _audit(_entry("upcast_then_gather", tick, _pool(torch.int8), quantized=True))


def _quant_good():
    def tick(pool, tables):  # each gathered tile dequantized after the table read
        acc = torch.zeros(_N, _D)
        for j in range(tables.shape[1]):
            col = tables[:, j].long()
            tile = pool["k"][0][col].float() * pool["k_scale"][0][col][:, None, None]
            acc = acc + tile.sum(dim=1)
        return acc
    return _audit(_entry("int8_tile_dequant", tick, _pool(torch.int8), quantized=True))


def _sentinel_bad():
    def tick(pool, tables):  # the probe folded to a constant "healthy" word
        return _streamed_read(pool, tables), torch.zeros(_N)
    return _audit(_entry("constant_health", tick, _pool(), health=lambda out: [out[1]]))


def _sentinel_good():
    def tick(pool, tables):  # health read from the tick's own output
        out = _streamed_read(pool, tables)
        return out, (out.sum(dim=-1) - 1.0).abs()
    return _audit(_entry("probed_tick", tick, _pool(), health=lambda out: [out[1]]))


AUDIT_FIXTURES = {
    "A-GATHER": (_gather_bad, _gather_good),
    "A-DONATE": (_donate_bad, _donate_good),
    "A-F64": (_f64_bad, _f64_good),
    "A-TRANSFER": (_transfer_bad, _transfer_good),
    "A-TRACEKEY": (_tracekey_bad, _tracekey_good),
    "A-QUANT": (_quant_bad, _quant_good),
    "A-SENTINEL": (_sentinel_bad, _sentinel_good),
}


def run_fixture(rule_id: str, which: str = "bad") -> list[Finding]:
    """Run one audit fixture through the real pipeline; returns findings."""
    bad, good = AUDIT_FIXTURES[rule_id]
    return bad() if which == "bad" else good()
