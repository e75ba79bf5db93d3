"""Weighted social graphs for the graph-cut path (Sec. 6.3).

* ``social_graph`` is a copy of ``benchmarks/common.py`` ``social_graph``
  (the port imports nothing of the reference or its benchmarks): the
  preferential-attachment graph the paper's Fig. 9 runs on, drawn with
  numpy from a seed, so both packages see the same matrix.  It is a Python
  loop, quadratic in n: the paper's 1,899 nodes take about a second.
* ``chung_lu_graph`` draws a graph of a real social network's size on the
  device: a Chung-Lu graph with power-law expected degrees (node i's
  weight proportional to (i + 1)^(-1 / (gamma - 1))), its edge endpoints
  drawn independently in proportion to the weights, self-loops and
  repeated pairs dropped, until exactly ``n_edges`` distinct undirected
  edges remain; each edge weighs an exponential(1) draw, as in
  ``social_graph``.  Returned as the dense symmetric (n, n) float32 matrix
  the graph-cut kernels read.
"""
from __future__ import annotations

import numpy as np
import torch


def social_graph(n: int = 512, m_edges: int = 4, seed: int = 0) -> np.ndarray:
  """Preferential-attachment (Barabasi-Albert-like) adjacency, weighted."""
  rng = np.random.default_rng(seed)
  deg = np.ones(n)
  w = np.zeros((n, n), np.float32)
  for v in range(1, n):
    p = deg[:v] / deg[:v].sum()
    targets = rng.choice(v, size=min(m_edges, v), replace=False, p=p)
    for t in targets:
      weight = rng.exponential(1.0)
      w[v, t] = w[t, v] = weight
      deg[v] += 1
      deg[t] += 1
  return w


def chung_lu_graph(n: int, n_edges: int, *, gamma: float = 2.1,
                   seed: int = 0, device="cuda") -> torch.Tensor:
  """Dense symmetric (n, n) float32 weights of a Chung-Lu graph with
  ``n_edges`` distinct undirected edges and power-law expected degrees of
  exponent ``gamma``, drawn on ``device`` from ``seed``."""
  if n_edges > n * (n - 1) // 2:
    raise ValueError(f"{n_edges} edges do not fit {n} nodes")
  dev = torch.device(device)
  g = torch.Generator(device=dev).manual_seed(seed)
  rank = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
  p = rank.pow(-1.0 / (gamma - 1.0))
  p = p / p.sum()
  keys = torch.empty((0,), dtype=torch.int64, device=dev)
  while keys.numel() < n_edges:  # a few rounds: repeats are dropped
    draw = 2 * (n_edges - keys.numel()) + 1024
    ends = torch.multinomial(p, 2 * draw, replacement=True, generator=g)
    a, b = ends[:draw], ends[draw:]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    new = (lo * n + hi)[lo != hi]
    keys = torch.unique(torch.cat([keys, new]))
  # a random n_edges of the distinct pairs (unique sorted them)
  keys = keys[torch.randperm(keys.numel(), generator=g,
                             device=dev)[:n_edges]]
  i, j = keys // n, keys % n
  wt = torch.empty((n_edges,), dtype=torch.float32,
                   device=dev).exponential_(1.0, generator=g)
  w = torch.zeros((n, n), dtype=torch.float32, device=dev)
  w[i, j] = wt
  w[j, i] = wt
  return w
