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

Over the ranks of a ``launch.mesh.ProcessMesh`` (``mesh=``) a rank's board
holds its own shards only: ``ages`` gives theirs, in shard order, which is
what the liveness collective takes from each rank.  A beat or a failure
for a shard another rank holds (a sidecar's ``POST /healthz`` on rank 0
naming rank 2's shard) is refused with a ``ValueError`` naming the owner,
never dropped in silence.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.obs.metrics import REGISTRY


class HeartbeatBoard:
  """Last-heartbeat timestamps for ``m`` shards, with an injectable clock."""

  def __init__(self, m: int, clock=time.monotonic, *, mesh=None):
    self._clock = clock
    self._m = m
    self._mesh = mesh
    self.first, count = (0, m) if mesh is None else (mesh.first, mesh.m_local)
    self._last = np.full((count,), float(clock()), np.float64)

  @property
  def m(self) -> int:
    """Shards of the whole service (a rank's board holds ``shards``)."""
    return self._m

  @property
  def shards(self) -> range:
    """The shards this board records."""
    return range(self.first, self.first + self._last.shape[0])

  def _slot(self, shard: int) -> int:
    """The board's entry of ``shard`` (stacked: the shard itself, as the
    reference indexes); a rank's board raises for a shard outside the
    service, or one another rank holds (naming it)."""
    if self._mesh is None:
      return shard
    shard = int(shard)
    if not 0 <= shard < self._m:
      raise ValueError(f"shard {shard} outside the service's {self._m}")
    if shard not in self.shards:
      per = self._last.shape[0]
      raise ValueError(
          f"shard {shard} is held by rank {shard // per}; this board is "
          f"rank {self._mesh.rank}'s (shards {self.first}.."
          f"{self.first + per - 1})")
    return shard - self.first

  def beat(self, shard: int | None = None, source: str = "inproc") -> None:
    """Record a heartbeat for ``shard`` (None = all shards); ``source``
    ("inproc" for fetch acks, "sidecar" for HTTP beats) labels the counter
    only."""
    now = float(self._clock())
    if shard is None:
      self._last[:] = now
    else:
      self._last[self._slot(shard)] = now
    REGISTRY.counter("repro_heartbeats_total",
                     "heartbeats recorded per source").inc(
                         source=source,
                         shard="all" if shard is None else shard)

  def fail(self, shard: int) -> None:
    """Mark ``shard`` dead: its age is +inf until it beats again."""
    self._last[self._slot(shard)] = -np.inf
    REGISTRY.counter("repro_heartbeat_failures_total",
                     "shards explicitly marked dead").inc(shard=shard)

  def ages(self, now: float | None = None) -> np.ndarray:
    """Seconds since each shard's last heartbeat (>= 0; inf = dead): (m,),
    or a rank's board its own shards'."""
    now = float(self._clock()) if now is None else float(now)
    return np.maximum(now - self._last, 0.0)
