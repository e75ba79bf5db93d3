"""The paper's approximation bounds as plain functions (a copy of
``src/repro/core/bounds.py``, which is pure ``math``: the port imports
nothing of the reference).  ``chip_smoke.py`` and the tests hold every
empirical GreeDi/centralized ratio to its theoretical floor with these."""
from __future__ import annotations

import math


def greedy_bound(l: int | None = None, k: int = 1) -> float:
  """Nemhauser et al. 1978 (Thm 2): f(A_gc[l]) >= (1 - e^{-l/k}) OPT_k."""
  l = k if l is None else l
  return 1.0 - math.exp(-l / k)


def thm3_bound(m: int, k: int) -> float:
  """Intractable two-round protocol: 1 / min(m, k) of the centralized OPT."""
  return 1.0 / min(m, k)


def thm4_bound(m: int, k: int, kappa: int | None = None) -> float:
  """GreeDi: (1 - e^{-kappa/k}) / min(m, k) of the centralized OPT."""
  kappa = k if kappa is None else kappa
  return (1.0 - math.exp(-kappa / k)) / min(m, k)


def thm11_bound() -> float:
  """Random partitioning, kappa = k (Barbosa et al. / Mirrokni & Z.):
  E[f(A_gd)] >= (1 - 1/e)/2 * OPT, for any m, k."""
  return (1.0 - math.exp(-1.0)) / 2.0


def thm8_bound(k: int, kappa: int, lam: float, alpha: float, opt: float) -> float:
  """Geometric-structure bound: (1 - e^{-kappa/k}) (OPT - lambda alpha k)."""
  return (1.0 - math.exp(-kappa / k)) * (opt - lam * alpha * k)


def thm9_n_required(k: int, m: int, delta: float, beta: float,
                    g_of_eps: float) -> float:
  """Sample size for the eps-close guarantee: n >= 8 k m log(k / delta^{1/m})
  / (beta g(eps / (lambda k)))."""
  return 8.0 * k * m * math.log(k / delta ** (1.0 / m)) / (beta * g_of_eps)


def thm12_bound(m: int, rho: int, tau: float) -> float:
  """Black-box X with tau-approximation under hereditary zeta:
  tau / min(m, rho(zeta))."""
  return tau / min(m, rho)


def stochastic_greedy_bound(eps: float) -> float:
  """Lazier-than-lazy greedy: 1 - 1/e - eps in expectation."""
  return 1.0 - math.exp(-1.0) - eps


def random_greedy_bound() -> float:
  """RandomGreedy (Buchbinder et al. 2014), non-monotone cardinality: 1/e."""
  return 1.0 / math.e


def hierarchical_bound(levels: int, m_per_level: int, k: int,
                       kappa: int) -> float:
  """Multi-round GreeDi (paper Sec. 4.2 remark): bounds compose
  multiplicatively across merge levels."""
  b = 1.0
  for _ in range(levels):
    b *= thm4_bound(m_per_level, k, kappa)
  return b
