"""Fixture: masked-reduction-without-mask bug class (T3), the PyTorch twin
of ``tests/analysis_fixtures/fixture_unmasked_reduction.py`` (R3).

Pad-and-mask blocks carry a gid column whose sign encodes row validity
(gid >= 0).  A row reduction that ignores it silently counts padding rows.
``bad_total_gain`` drops the mask; ``good_total_gain`` is the masked twin
that consumes the gid-validity taint and must NOT be flagged.
"""
import numpy as np
import torch

N_ROWS = 48  # the pad-and-mask row size the analyzer is told about
D = 16


def bad_total_gain(feats, gids, weights):
  gains = feats @ weights  # (N_ROWS,)
  return torch.sum(gains)  # BUG: reduces over padding rows too


def good_total_gain(feats, gids, weights):
  gains = feats @ weights
  valid = (gids >= 0).to(gains.dtype)
  return torch.sum(gains * valid)  # masked twin: consumes the taint


def args():
  g = np.random.default_rng(0)
  gids = np.where(g.uniform(size=N_ROWS) < 0.2, -1, np.arange(N_ROWS))
  return (torch.tensor(g.standard_normal((N_ROWS, D)), dtype=torch.float32),
          torch.tensor(gids), torch.tensor(g.standard_normal(D),
                                           dtype=torch.float32))
