"""The selection service (the port of ``src/repro/service``): the
device-resident ``CorpusStore`` with its warm-bound table and standing
sieves, the ``SelectionService`` epochs and queries, the ``QueryBatcher``
and the ``HeartbeatBoard``."""
from repro_torch.service.batching import BatcherStats, QueryBatcher
from repro_torch.service.heartbeat import HeartbeatBoard
from repro_torch.service.service import (EpochResult, EpochStats,
                                         QueryRequest, QueryResult,
                                         SelectionService)
from repro_torch.service.store import CorpusStore, SieveState

__all__ = ["BatcherStats", "CorpusStore", "EpochResult", "EpochStats",
           "HeartbeatBoard", "QueryBatcher", "QueryRequest", "QueryResult",
           "SelectionService", "SieveState"]
