"""The selection service's epoch path (the port of ``src/repro/service``):
the device-resident ``CorpusStore`` with its warm-bound table, the
``SelectionService`` epochs and the ``HeartbeatBoard``.  The standing
sieves, the queries and ``QueryBatcher`` are not ported yet (ROADMAP.md)."""
from repro_torch.service.heartbeat import HeartbeatBoard
from repro_torch.service.service import (EpochResult, EpochStats,
                                         SelectionService)
from repro_torch.service.store import CorpusStore

__all__ = ["CorpusStore", "EpochResult", "EpochStats", "HeartbeatBoard",
           "SelectionService"]
