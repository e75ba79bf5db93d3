"""Synthetic embedded corpus (the port of ``EmbeddedCorpus.features`` in
``src/repro/data/pipeline.py``).

The documents' feature embeddings are a k-cluster Gaussian mixture on the
unit sphere, drawn on the device from a seeded ``torch.Generator``: the same
distribution as the reference's draw, not the same bits (the tests feed
numpy features to both sides instead).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device


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

  def features(self) -> torch.Tensor:
    dev = resolve_device(self.device)
    g = torch.Generator(device=dev).manual_seed(self.seed)
    centers = torch.randn((self.n_clusters, self.feat_dim), generator=g,
                          device=dev)
    centers = centers / torch.linalg.norm(centers, dim=1, keepdim=True)
    assign = torch.randint(0, self.n_clusters, (self.n_docs,), generator=g,
                           device=dev)
    noise = 0.3 * torch.randn((self.n_docs, self.feat_dim), generator=g,
                              device=dev)
    f = centers[assign] + noise
    return f / torch.linalg.norm(f, dim=1, keepdim=True)
