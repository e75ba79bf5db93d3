"""Fixture: the rank rules (T2, T7), as entries over a process mesh.

Importing this module registers four entries for ``trace_check.
check_ranked``; each runs on every rank with that rank's ``ProcessMesh``:

* ``fx:t7_replicated`` sums a penalty that is the same on every rank: the
  sum counts it once a rank (T7);
* ``fx:t7_sharded`` is the twin: every summed operand is the rank's own;
* ``fx:t2_agree`` issues the same collectives on every rank;
* ``fx:t2_divergent`` issues one more collective on rank 1 than on rank 0:
  rank 1 waits on a collective nobody joins (T2).  It runs last: its group
  is broken afterwards.
"""
import numpy as np
import torch

from repro_torch.kernels import dispatch


def _local(mesh, dev):
  g = np.random.default_rng(100 + mesh.rank)
  return torch.tensor(g.standard_normal((16, 4)), dtype=torch.float32,
                      device=dev)


def replicated_score(local, weights, mesh):
  partial = (local @ weights).sum()             # rank-varying: its rows
  penalty = 0.5 * (weights * weights).sum()     # the same on every rank
  score = mesh.sum(partial)
  return score - mesh.sum(penalty)  # BUG: penalty * world


def sharded_score(local, weights, mesh):
  partial = (local @ weights).sum()
  penalty = 0.5 * (weights * weights).sum() * (mesh.rank == 0)
  return mesh.sum(partial - penalty)  # the penalty enters once


def agree(local, mesh):
  return mesh.all_gather(local.sum(dim=0, keepdim=True))


def divergent(local, mesh):
  out = mesh.all_gather(local.sum(dim=0, keepdim=True))
  if mesh.rank == 1:
    out = mesh.max(out)  # BUG: a collective rank 0 never issues
  return out


def _spec(fn, with_weights: bool):
  def build(dev, mesh):
    local = _local(mesh, dev)
    w = torch.linspace(-1.0, 1.0, 4, device=dev)
    args = (local, w) if with_weights else (local,)
    return dispatch.TraceSpec(fn=lambda *a: fn(*a, mesh), args=args)
  return build


ENTRIES = ("fx:t7_replicated", "fx:t7_sharded", "fx:t2_agree",
           "fx:t2_divergent")
for _name, _fn, _w in zip(ENTRIES, (replicated_score, sharded_score, agree,
                                    divergent), (True, True, False, False)):
  dispatch.register_entry_point(_name, _spec(_fn, _w), needs_ranks=2)
