"""Fixture: host syncs above an entry's budget (T1).

``bad_scores`` reads each row's score back to the host inside its loop:
three syncs in one call against a budget of one.  ``good_scores`` is the
clean twin: the scores stay on the device and one read-back ends the call.
"""
import torch

BUDGET = 1


def bad_scores(feats, weights):
  total = 0.0
  for i in range(3):
    total += float(feats[i] @ weights)  # BUG: one host sync a row
  return total


def good_scores(feats, weights):
  scores = feats[:3] @ weights
  return float(scores.sum())  # clean twin: one read-back for the call


def args():
  g = torch.Generator().manual_seed(0)
  return torch.randn(8, 4, generator=g), torch.randn(4, generator=g)
