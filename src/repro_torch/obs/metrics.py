"""Process-wide metrics registry: counters, gauges, histograms with labels
(the port of ``src/repro/obs/metrics.py``, the same names, label sets, kind
checks and ``snapshot()`` shape; plain Python, kept to the reference's
behaviour).

One registry instance (``obs.REGISTRY``) serves the whole process.  An
``inc`` / ``set`` / ``observe`` is a dict lookup plus an int or float
update under a lock, so instrumented call sites leave them on.  What
``obs.enable()`` gates is everything with a real cost: device-to-host reads
of the device-fed diagnostics, JSONL span emission and the profiler / NVTX
annotations (see trace.py).

Label sets are keyword arguments and part of the series identity,
Prometheus-style::

    REGISTRY.counter("repro_queries_total").inc(tier="sieve")
    REGISTRY.gauge("repro_alive_shards").set(3)
    REGISTRY.histogram("repro_epoch_wall_seconds").observe(1.2)

``snapshot()`` returns a plain-dict, JSON-serializable view consumed by
``export.prometheus_text`` (the sidecar's /metrics), ``write_stats_json``
and tests.
"""
from __future__ import annotations

import threading
from typing import Iterable

# default histogram buckets: latency-shaped, 100us .. 30s (seconds)
_DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
                    10.0, 30.0)


def _label_key(labels: dict) -> tuple:
  return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
  """Monotone counter with label sets."""

  def __init__(self, name: str, help: str, lock: threading.Lock):
    self.name, self.help = name, help
    self._lock = lock
    self._series: dict[tuple, float] = {}

  def inc(self, value: float = 1.0, **labels) -> None:
    if value < 0:
      raise ValueError(f"counter {self.name} cannot decrease (got {value})")
    key = _label_key(labels)
    with self._lock:
      self._series[key] = self._series.get(key, 0.0) + value

  def get(self, **labels) -> float:
    with self._lock:
      return self._series.get(_label_key(labels), 0.0)

  def snapshot(self) -> dict:
    with self._lock:
      series = [{"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())]
    return {"type": "counter", "help": self.help, "series": series}


class Gauge:
  """Last-value gauge with label sets."""

  def __init__(self, name: str, help: str, lock: threading.Lock):
    self.name, self.help = name, help
    self._lock = lock
    self._series: dict[tuple, float] = {}

  def set(self, value: float, **labels) -> None:
    with self._lock:
      self._series[_label_key(labels)] = float(value)

  def get(self, **labels) -> float:
    with self._lock:
      return self._series.get(_label_key(labels), 0.0)

  def snapshot(self) -> dict:
    with self._lock:
      series = [{"labels": dict(k), "value": v}
                for k, v in sorted(self._series.items())]
    return {"type": "gauge", "help": self.help, "series": series}


class Histogram:
  """Cumulative-bucket histogram (Prometheus semantics) with label sets."""

  def __init__(self, name: str, help: str, lock: threading.Lock,
               buckets: Iterable[float] = _DEFAULT_BUCKETS):
    self.name, self.help = name, help
    self.buckets = tuple(sorted(float(b) for b in buckets))
    self._lock = lock
    # per label set: (bucket counts, sum, count)
    self._series: dict[tuple, tuple[list[int], float, int]] = {}

  def observe(self, value: float, **labels) -> None:
    key = _label_key(labels)
    with self._lock:
      counts, total, n = self._series.get(
          key, ([0] * len(self.buckets), 0.0, 0))
      for i, b in enumerate(self.buckets):
        if value <= b:
          counts[i] += 1
      self._series[key] = (counts, total + float(value), n + 1)

  def get(self, **labels) -> dict:
    """{"count", "sum", "buckets": {le: cumulative}} for one label set."""
    with self._lock:
      counts, total, n = self._series.get(
          _label_key(labels), ([0] * len(self.buckets), 0.0, 0))
      return {"count": n, "sum": total,
              "buckets": dict(zip(self.buckets, counts))}

  def snapshot(self) -> dict:
    with self._lock:
      series = [{"labels": dict(k), "count": n, "sum": total,
                 "buckets": {str(b): c for b, c in zip(self.buckets, counts)}}
                for k, (counts, total, n) in sorted(self._series.items())]
    return {"type": "histogram", "help": self.help,
            "bucket_bounds": list(self.buckets), "series": series}


class Registry:
  """Named metric registry; get-or-create accessors are the public surface.

  A name maps to exactly one metric kind for the registry lifetime
  (re-declaring with a different kind raises -- the usual Prometheus
  single-writer discipline).
  """

  def __init__(self):
    self._lock = threading.Lock()
    self._metrics: dict[str, object] = {}

  def _get_or_create(self, name: str, cls, help: str, **kw):
    with self._lock:
      m = self._metrics.get(name)
      if m is None:
        m = cls(name, help, threading.Lock(), **kw)
        self._metrics[name] = m
      elif not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {cls.__name__}")
      return m

  def counter(self, name: str, help: str = "") -> Counter:
    return self._get_or_create(name, Counter, help)

  def gauge(self, name: str, help: str = "") -> Gauge:
    return self._get_or_create(name, Gauge, help)

  def histogram(self, name: str, help: str = "",
                buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
    return self._get_or_create(name, Histogram, help, buckets=buckets)

  def snapshot(self) -> dict:
    """JSON-serializable {name: metric snapshot} view of every series."""
    with self._lock:
      metrics = list(self._metrics.items())
    return {name: m.snapshot() for name, m in metrics}

  def reset(self) -> None:
    """Drop every metric (tests / fresh collections)."""
    with self._lock:
      self._metrics.clear()


# THE process-wide registry every instrumented module writes to
REGISTRY = Registry()
