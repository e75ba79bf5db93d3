"""Micro-batching request loop of the multi-tenant query path (the port of
``src/repro/service/batching.py``).

``SelectionService.query_batch`` answers a whole request batch with one
merge call a query tile, but tenants arrive one at a time.
``QueryBatcher`` turns the one into the other: ``submit()`` enqueues a
``QueryRequest`` and returns a future, and a worker thread drains the queue
through ONE ``query_batch`` call whenever

* ``max_batch`` requests have accumulated (the store's query tile by
  default: a full tile is the highest-throughput drain), or
* ``max_delay_s`` has passed since the oldest pending request (the latency
  knob: no request waits longer than the deadline plus one drain).

Every request of a drained batch observes the same wall clock
(``QueryResult.wall_s``).  On a rank of a process mesh the sieve tier
answers from the rank's replica of the pooled sieves with no collective,
so a batcher works on any rank alone; the exact tier is a collective
(every rank calls it with the same batch), which a batcher's drains cannot
line up, so it is refused there.  Closing drains what is pending, it drops
nothing.  Each drain is a ``batcher.drain`` span (tier, occupancy) and
feeds the ``repro_batcher_*`` series.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

from repro_torch import obs
from repro_torch.service.service import QueryRequest


@dataclasses.dataclass
class BatcherStats:
  """Counters of one ``QueryBatcher`` lifetime."""
  submitted: int = 0      # requests accepted by submit()
  served: int = 0         # requests resolved (results or errors)
  batches: int = 0        # query_batch drains
  max_occupancy: int = 0  # largest drained batch (<= max_batch)

  @property
  def mean_occupancy(self) -> float:
    return self.served / self.batches if self.batches else 0.0


class QueryBatcher:
  """Accumulate-until-B-or-deadline micro-batcher over ``query_batch``.

  Thread-based: the drain is one blocking call (PyTorch releases the GIL
  in its kernels and copies), so submitters keep enqueueing while a batch
  is in flight.  Use as a context manager or call ``close()``.

  Args:
    service: the ``SelectionService`` to drain through.
    max_batch: drain threshold; None = the store's query tile (larger
      values work too: the store runs tile by tile).
    max_delay_s: the longest the oldest pending request waits before a
      (possibly partial) drain.
    tier: forwarded to ``query_batch`` ("sieve" | "exact"; "sieve" only
      on a rank of a process mesh).
  """

  def __init__(self, service, *, max_batch: int | None = None,
               max_delay_s: float = 0.002, tier: str = "sieve"):
    self._svc = service
    self._max_batch = int(max_batch or service.store.query_batch_tile)
    if self._max_batch <= 0:
      raise ValueError(f"max_batch must be positive, got {self._max_batch}")
    self._max_delay = float(max_delay_s)
    if tier == "exact" and getattr(service, "mesh", None) is not None:
      raise ValueError("the exact tier is a collective over the mesh's "
                       "ranks: call query_batch(tier='exact') on every rank "
                       "together, not through a QueryBatcher")
    self._tier = tier
    self._cv = threading.Condition()
    self._pending: list[tuple[QueryRequest, Future]] = []
    self._closed = False
    self.stats = BatcherStats()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name="repro-torch-query-batcher")
    self._thread.start()

  def submit(self, request: QueryRequest | None = None) -> Future:
    """Enqueue one request; the future resolves to its ``QueryResult``
    once the batch it rides in has drained."""
    req = request if request is not None else QueryRequest()
    fut: Future = Future()
    with self._cv:
      if self._closed:
        raise RuntimeError("QueryBatcher is closed")
      self._pending.append((req, fut))
      self.stats.submitted += 1
      self._cv.notify()
    return fut

  def _loop(self) -> None:
    while True:
      with self._cv:
        while not self._pending and not self._closed:
          self._cv.wait()
        if not self._pending and self._closed:
          return
        # the deadline runs from the oldest pending request: wait for a
        # full tile, never past the deadline
        deadline = time.perf_counter() + self._max_delay
        while len(self._pending) < self._max_batch and not self._closed:
          left = deadline - time.perf_counter()
          if left <= 0:
            break
          self._cv.wait(timeout=left)
        batch = self._pending[:self._max_batch]
        del self._pending[:self._max_batch]
      with obs.span("batcher.drain", tier=self._tier,
                    occupancy=len(batch)) as sp:
        try:
          results = self._svc.query_batch([r for r, _ in batch],
                                          tier=self._tier)
          for (_, fut), res in zip(batch, results):
            fut.set_result(res)
        except Exception as e:  # a bad request fails only its own batch
          for _, fut in batch:
            fut.set_exception(e)
      self.stats.batches += 1
      self.stats.served += len(batch)
      self.stats.max_occupancy = max(self.stats.max_occupancy, len(batch))
      reg = obs.REGISTRY
      reg.counter("repro_batcher_requests_total",
                  "requests drained by the micro-batcher").inc(len(batch))
      reg.counter("repro_batcher_batches_total",
                  "micro-batch drains").inc()
      reg.gauge("repro_batcher_occupancy",
                "requests in the last drained batch").set(len(batch))
      reg.histogram("repro_batcher_drain_wall_seconds",
                    "wall clock of one drain (the request latency "
                    "surface)").observe(sp.wall_s)

  def close(self) -> None:
    """Stop accepting requests, drain what is pending, join the worker."""
    with self._cv:
      self._closed = True
      self._cv.notify_all()
    self._thread.join()

  def __enter__(self) -> "QueryBatcher":
    return self

  def __exit__(self, *exc) -> None:
    self.close()
