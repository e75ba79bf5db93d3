"""Observability of the port (the port of ``src/repro/obs``): the metrics
registry, trace spans and the HTTP sidecar.

    from repro_torch import obs

    obs.enable(trace_out="trace.jsonl")       # off by default
    obs.REGISTRY.counter("repro_queries_total").inc(tier="sieve")
    with obs.span("service.epoch", epoch=i) as sp: ...
    side = obs.Sidecar(board=svc.board, port=0)

The contract (it replaces the reference's no-retrace rule, as nothing is
compiled here):

  * Device-fed diagnostics (per-shard eval mass, lazy rescans, merge
    rows, sieve admissions and considered rows) are computed on the device
    every time; they are read to the host only while ``obs.enabled()``,
    so with obs off an append chunk makes no host sync and a query tile
    one.
  * Registry updates are always on (a locked dict update each), so a
    stats dump carries the cheap counters even with obs off.
"""
from repro_torch.obs.export import (prometheus_text, stats_line,
                                    write_stats_json)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     Registry)
from repro_torch.obs.sidecar import Sidecar
from repro_torch.obs.trace import (Span, disable, enable, enabled, span,
                                   trace_out_path)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "Sidecar", "Span", "span",
    "enable", "disable", "enabled", "trace_out_path",
    "prometheus_text", "stats_line", "write_stats_json",
]
