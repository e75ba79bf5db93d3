"""Per-shard heartbeat registry feeding the protocol's liveness collective
(the port of ``src/repro/service/heartbeat.py``; host-side, pure Python).

The board records *when* each shard last reported healthy (``beat``) and
turns that into per-shard ages (``ages``).  The decision "is this shard
alive?" is not made here: the ages go into the sharded GreeDi protocol,
whose deadline-based liveness collective (core/greedi.py) derives the
straggler mask and reports it back as ``GreediResult.alive``.  The obs
sidecar's ``POST /healthz`` calls ``beat(shard, source="sidecar")`` on the
same board, so HTTP beats and in-process fetch acks are the same to the
liveness collective (``source`` only labels ``repro_heartbeats_total``).
Tests inject a fake ``clock`` and call ``fail`` to kill shards
deterministically.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.obs.metrics import REGISTRY


class HeartbeatBoard:
  """Last-heartbeat timestamps for ``m`` shards, with an injectable clock."""

  def __init__(self, m: int, clock=time.monotonic):
    self._clock = clock
    self._last = np.full((m,), float(clock()), np.float64)

  @property
  def m(self) -> int:
    return self._last.shape[0]

  def beat(self, shard: int | None = None, source: str = "inproc") -> None:
    """Record a heartbeat for ``shard`` (None = all shards); ``source``
    ("inproc" for fetch acks, "sidecar" for HTTP beats) labels the counter
    only."""
    now = float(self._clock())
    if shard is None:
      self._last[:] = now
    else:
      self._last[shard] = now
    REGISTRY.counter("repro_heartbeats_total",
                     "heartbeats recorded per source").inc(
                         source=source,
                         shard="all" if shard is None else shard)

  def fail(self, shard: int) -> None:
    """Mark ``shard`` dead: its age is +inf until it beats again."""
    self._last[shard] = -np.inf
    REGISTRY.counter("repro_heartbeat_failures_total",
                     "shards explicitly marked dead").inc(shard=shard)

  def ages(self, now: float | None = None) -> np.ndarray:
    """(m,) seconds since each shard's last heartbeat (>= 0; inf = dead)."""
    now = float(self._clock()) if now is None else float(now)
    return np.maximum(now - self._last, 0.0)
