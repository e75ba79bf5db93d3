"""Exposition formats: Prometheus text, unified stats lines, stats JSON
(the port of ``src/repro/obs/export.py``; the same bytes for the same
registry).

``prometheus_text`` renders a registry snapshot in the Prometheus text
exposition format (the sidecar's ``/metrics`` body): HELP/TYPE headers,
``name{label="v"} value`` samples, and the ``_bucket``/``_sum``/``_count``
triplet with cumulative ``le`` labels for histograms.

``stats_line`` is the one human-readable stats format every launch/select
mode prints (service epochs, standing-sieve queries, batched serving): an
event name followed by ``key=value`` pairs, floats compacted.  The paired
``write_stats_json`` persists the same records machine-readably together
with a full registry snapshot (the ``--stats-json`` flag).
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import REGISTRY, Registry


def _fmt_label(labels: dict) -> str:
  if not labels:
    return ""
  inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
  return "{" + inner + "}"


def _fmt_value(v: float) -> str:
  if v == float("inf"):
    return "+Inf"
  f = float(v)
  return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: Registry | None = None) -> str:
  """Render every registered series in the Prometheus text format."""
  snap = (registry or REGISTRY).snapshot()
  out: list[str] = []
  for name in sorted(snap):
    m = snap[name]
    if m["help"]:
      out.append(f"# HELP {name} {m['help']}")
    out.append(f"# TYPE {name} {m['type']}")
    if m["type"] in ("counter", "gauge"):
      for s in m["series"]:
        out.append(f"{name}{_fmt_label(s['labels'])} "
                   f"{_fmt_value(s['value'])}")
    else:  # histogram: cumulative le buckets + _sum/_count
      bounds = m["bucket_bounds"]
      for s in m["series"]:
        for b in bounds:
          cum = s["buckets"][str(b)]
          lab = dict(s["labels"], le=_fmt_value(b))
          out.append(f"{name}_bucket{_fmt_label(lab)} {cum}")
        lab = dict(s["labels"], le="+Inf")
        out.append(f"{name}_bucket{_fmt_label(lab)} {s['count']}")
        out.append(f"{name}_sum{_fmt_label(s['labels'])} "
                   f"{_fmt_value(s['sum'])}")
        out.append(f"{name}_count{_fmt_label(s['labels'])} {s['count']}")
  return "\n".join(out) + "\n"


def _compact(v) -> str:
  if isinstance(v, bool):
    return str(v).lower()
  if isinstance(v, float):
    a = abs(v)
    if a != 0 and (a < 1e-3 or a >= 1e5):
      return f"{v:.3e}"
    return f"{v:.4f}".rstrip("0").rstrip(".")
  return str(v)


def stats_line(event: str, **fields) -> str:
  """The unified stats-line format: ``event key=value key=value ...``.

  Field order is the caller's keyword order (python dicts preserve it), so
  lines stay scannable; floats render compactly and bools lowercase.
  """
  parts = [event] + [f"{k}={_compact(v)}" for k, v in fields.items()]
  return " ".join(parts)


def write_stats_json(path: str, records: list[dict], **meta) -> None:
  """Persist stats records + a registry snapshot (``--stats-json``)."""
  payload = dict(meta)
  payload["stats"] = records
  payload["metrics"] = REGISTRY.snapshot()
  with open(path, "w") as f:
    json.dump(payload, f, indent=2, sort_keys=True)
    f.write("\n")
