"""Synthetic LM tokens, the synthetic embedded corpus and the train-side
consumers of a selection stream (the port of ``SyntheticLM``,
``EmbeddedCorpus`` and ``batches_from_indices`` / ``batches_from_epochs``
in ``src/repro/data/pipeline.py``).

``SyntheticLM``: every batch is a pure function of (seed, step), so a
restart resumes mid-stream with no iterator state to checkpoint, and a
shard's slice is a pure function of (seed, step, its rows): each row is
drawn by its own generator seeded with (seed, step, global row), so the
slices of any (shard, num_shards) factorization concatenate to the global
batch.  The draws cannot match ``jax.random``'s bits; the distribution
(a truncated power law) is the reference's.

The documents' feature embeddings are a k-cluster Gaussian mixture on the
unit sphere, drawn on the device from a seeded ``torch.Generator``: the same
distribution as the reference's draw, not the same bits (the tests feed
numpy features to both sides instead).  Each document's token sequence is
drawn from its cluster's band of the vocabulary, by a generator seeded
with the corpus seed and the document id, so a document's tokens never
depend on which batch asks for them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


def _row_uniforms(seeds, width: int) -> torch.Tensor:
  """(len(seeds), width) float32 uniforms on [1e-6, 1), row r from a CPU
  generator seeded with ``seeds[r]`` (the same bits on every device)."""
  u = torch.empty((len(seeds), width), dtype=torch.float32)
  for r, seed in enumerate(seeds):
    g = torch.Generator().manual_seed(int(seed) % 2**63)
    u[r] = torch.rand((width,), generator=g)
  return 1e-6 + (1.0 - 1e-6) * u


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
  """Zipf-like token sequences for LM training: tokens = vocab * u **
  zipf_alpha (the inverse CDF of a truncated power law), u uniform on
  [1e-6, 1).  ``device`` defaults to ``cuda`` and raises when CUDA is
  missing unless ``cpu`` is asked for."""
  vocab: int
  seq_len: int
  global_batch: int
  seed: int = 0
  zipf_alpha: float = 1.2
  device: str = "cuda"

  def batch(self, step: int, *, shard: int = 0, num_shards: int = 1) -> dict:
    """The shard's slice of global batch ``step``: {"tokens", "labels"
    (b, seq_len) int64, "mask" (b, seq_len) float32}, b = global_batch /
    num_shards, rows shard * b .. (shard + 1) * b of the global batch."""
    if self.global_batch % num_shards:
      raise ValueError(f"global batch {self.global_batch} is not a multiple "
                       f"of {num_shards} shards")
    dev = resolve_device(self.device)
    b = self.global_batch // num_shards
    base = (self.seed * 1_000_003 + step) * 1_000_003
    u = _row_uniforms([base + shard * b + r for r in range(b)],
                      self.seq_len + 1).to(dev)
    toks = (self.vocab * u ** self.zipf_alpha).to(torch.int64).clamp(
        0, self.vocab - 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((b, self.seq_len), dtype=torch.float32,
                               device=dev)}


@dataclasses.dataclass(frozen=True)
class EmbeddedCorpus:
  """n documents with feature embeddings on the unit sphere, clustered so
  facility-location selection has real structure (the regime of the
  paper's Theorems 8-9).  ``device`` defaults to ``cuda`` and raises when
  CUDA is missing unless ``cpu`` is asked for."""
  n_docs: int
  feat_dim: int
  n_clusters: int = 32
  seed: int = 0
  device: str = "cuda"
  vocab: int = 1024
  seq_len: int = 8

  def _draw(self):
    """(generator, centers, assignments): the first two draws of the
    corpus, shared by ``features`` and ``cluster_assignments``."""
    dev = resolve_device(self.device)
    g = torch.Generator(device=dev).manual_seed(self.seed)
    centers = torch.randn((self.n_clusters, self.feat_dim), generator=g,
                          device=dev)
    assign = torch.randint(0, self.n_clusters, (self.n_docs,), generator=g,
                           device=dev)
    return g, centers, assign

  def cluster_assignments(self) -> torch.Tensor:
    """(n_docs,) int64 mixture component of every document."""
    return self._draw()[2]

  def tokens_for(self, doc_ids) -> dict:
    """Token sequences of the given documents: {"tokens", "labels" (b,
    seq_len) int64, "mask" (b, seq_len) float32}.  Tokens come from the
    document's cluster band of the vocabulary (band * u^1.1 + cluster *
    band, u uniform on [1e-6, 1)), so a model trained on a coreset that
    covers every cluster sees the whole token distribution."""
    dev = resolve_device(self.device)
    ids = torch.as_tensor(np.asarray(doc_ids), dtype=torch.int64)
    assign = self.cluster_assignments()[ids.to(dev)]
    u = _row_uniforms([(self.seed + 1) * 1_000_003 + i for i in ids.tolist()],
                      self.seq_len + 1).to(dev)
    band = self.vocab // self.n_clusters
    toks = ((band * u ** 1.1).to(torch.int64) + assign[:, None] * band).clamp(
        0, self.vocab - 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((ids.shape[0], self.seq_len),
                               dtype=torch.float32, device=dev)}

  def features(self) -> torch.Tensor:
    g, centers, assign = self._draw()
    dev = centers.device
    centers = centers / torch.linalg.norm(centers, dim=1, keepdim=True)
    noise = 0.3 * torch.randn((self.n_docs, self.feat_dim), generator=g,
                              device=dev)
    f = centers[assign] + noise
    return f / torch.linalg.norm(f, dim=1, keepdim=True)


def batches_from_indices(corpus: EmbeddedCorpus, indices, batch_size: int,
                         steps: int, seed: int = 0, *, board=None,
                         shard: int | None = None, start: int = 0):
  """Cycle ``steps`` token batches over a selected index set (documents
  drawn with replacement only when the set is smaller than a batch).

  ``start`` skips the first ``start`` batches, as a resumed run must: their
  index draws advance the generator, but no tokens are built and no
  heartbeat is sent, so the batches from ``start`` on are those of a run
  from 0.

  ``board`` / ``shard`` wire the consumer to a
  ``service.heartbeat.HeartbeatBoard``: every batch fetch beats the
  consuming shard's heartbeat (``shard=None`` beats every shard).  The
  data-fetch ack is the liveness signal: a trainer shard that stops
  pulling batches stops beating, its age crosses the service's deadline,
  and the next epoch's liveness collective masks it out.
  """
  rng = np.random.default_rng(seed)
  idx = np.asarray(indices)
  for step in range(steps):
    take = rng.choice(idx, size=batch_size, replace=len(idx) < batch_size)
    if step < start:
      continue
    if board is not None:
      board.beat(shard)
    yield corpus.tokens_for(take)


def batches_from_epochs(corpus: EmbeddedCorpus, selections, batch_size: int,
                        steps_per_epoch: int, seed: int = 0, *, board=None,
                        shard: int | None = None):
  """Train-side consumer of a multi-epoch selection stream: each epoch's
  index array (e.g. from ``SelectionService.selections``) feeds
  ``steps_per_epoch`` batches through ``batches_from_indices`` with an
  epoch-distinct seed, the heartbeat acks threaded through."""
  for e, idx in enumerate(selections):
    yield from batches_from_indices(corpus, idx, batch_size,
                                    steps_per_epoch, seed=seed + e,
                                    board=board, shard=shard)
