"""Non-monotone + general constraints (Sec. 5) on the PyTorch/CUDA port:
distributed max-cut under a partition-matroid constraint with RandomGreedy
as the black-box algorithm X (Alg. 3 / Thm 12).  The counterpart of
``examples/maxcut_constrained.py``.

Scenario: pick at most ``--cap`` "seed" nodes per community of a social
graph to maximize the cut (the influence boundary) -- matroid-constrained
non-monotone submodular maximization, run distributed.  X runs on every
partition at once (one stacked greedy, each partition cutting the subgraph
its nodes induce), then once more over the merged set B on the whole
graph; the answer is the better of that and the best single machine.

    PYTHONPATH=src python examples/maxcut_constrained_torch.py            # card
    PYTHONPATH=src python examples/maxcut_constrained_torch.py --device cpu
    # a graph of the SNAP email-Enron graph's size, drawn on the card
    PYTHONPATH=src python examples/maxcut_constrained_torch.py \
        --graph chung-lu --n 36692 --edges 183831 --communities 32 --m 16

Every gain pass runs the ``graph_cut_gain`` CUDA kernel on the card;
``--device cpu`` runs its plain PyTorch version.  The social graph is the
reference's own generator (the same matrix for the same seed); the random
draws come from seeded ``torch.Generator``s, so the selections are the
reference's in distribution, not bit for bit.
"""
import argparse

import torch

from repro_torch import no_tf32, resolve_device
from repro_torch.core import bounds
from repro_torch.core import constraints as C
from repro_torch.core import objectives as O
from repro_torch.core.greedi import set_value_feats
from repro_torch.core.greedy import greedy
from repro_torch.core.partition import random_partition
from repro_torch.data.graphs import chung_lu_graph, social_graph


def alg3(w: torch.Tensor, comm: torch.Tensor, matroid, m: int, k: int, *,
         seed: int = 0, obj=None, perm: torch.Tensor | None = None,
         draws: dict | None = None) -> dict:
  """Alg. 3 with X = RandomGreedy under ``matroid`` on the graph ``w`` (as
  ``GraphCut.init_w`` prepared it), beside the centralized X.  ``comm``
  holds each node's community (the matroid's part ids).  The partition and
  the draws come from generators seeded by ``seed``, unless ``perm`` (an
  (m, ceil(n/m)) partition, -1 padding) and ``draws`` (rank tables
  "central" (k, kk), "r1" (m, k, kk), "merged" (k, kk); see
  ``greedy.draw_table``) inject another implementation's.  Returns the
  cuts, the selected node ids and the Thm-12 floor."""
  obj = O.GraphCut(backend="auto") if obj is None else obj
  draws = {} if draws is None else draws
  dev = w.device
  n = w.shape[0]
  eye = torch.eye(n, dtype=torch.float32, device=dev)
  st = obj.init_induced(w)

  def gen(i):
    return torch.Generator(device=dev).manual_seed(seed * 1000 + i)

  # centralized black-box X = RandomGreedy under the matroid
  rc = greedy(obj, st, eye, k, constraint=matroid, meta={"part": comm},
              mode="random", rng=gen(0), draws=draws.get("central"),
              stop_nonpositive=True)

  # GreeDi under constraints (Alg. 3): X on each partition's induced
  # subgraph, all partitions in one stacked run over the shared W
  parts, pmask, perm = random_partition(None if perm is not None else gen(1),
                                        eye, m, perm=perm)
  ind = torch.zeros((m, n), dtype=torch.float32, device=dev).scatter_add(
      1, perm.clamp_min(0), pmask.to(torch.float32))
  r1 = greedy(obj, obj.init_induced(w, ind), parts, k, cand_mask=pmask,
              constraint=matroid, meta={"part": comm[perm.clamp_min(0)]},
              mode="random", rng=gen(2), draws=draws.get("r1"),
              stop_nonpositive=True)
  del parts

  # merge B and run X once more on the union (global objective)
  b_idx = torch.gather(perm, 1, r1.idx.clamp_min(0)).reshape(-1)
  b_valid = (r1.idx >= 0).reshape(-1)
  rb = greedy(obj, st, eye[b_idx], k, cand_mask=b_valid, constraint=matroid,
              meta={"part": comm[b_idx]}, mode="random", rng=gen(3),
              draws=draws.get("merged"), stop_nonpositive=True)

  # best single machine, evaluated on the whole graph
  singles = obj.value(set_value_feats(obj, obj.broadcast(st, m), r1.feats,
                                      r1.idx >= 0))
  best = int(torch.argmax(singles))
  v_b, v_single = float(obj.value(rb.state)), float(singles[best])
  if v_b >= v_single:
    ids = b_idx[rb.idx[rb.idx >= 0]]
  else:
    ids = perm[best][r1.idx[best][r1.idx[best] >= 0]]
  v_c = float(obj.value(rc.state))
  v_d = max(v_b, v_single)
  return dict(v_centralized=v_c, v_merged=v_b, v_best_single=v_single,
              v_greedi=v_d, ratio=v_d / v_c,
              thm12_floor=bounds.thm12_bound(m, matroid.rho(),
                                             bounds.random_greedy_bound()),
              ids=ids, centralized_ids=rc.idx[rc.idx >= 0],
              r1_ids=torch.where(r1.idx >= 0,
                                 torch.gather(perm, 1, r1.idx.clamp_min(0)),
                                 -1))


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  ap.add_argument("--graph", default="social",
                  choices=("social", "chung-lu"))
  ap.add_argument("--n", type=int, default=256)
  ap.add_argument("--edges", type=int, default=183831,
                  help="edges of the chung-lu graph")
  ap.add_argument("--communities", type=int, default=8)
  ap.add_argument("--cap", type=int, default=2)
  ap.add_argument("--m", type=int, default=4)
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  no_tf32()
  dev = resolve_device(args.device)
  n, n_comm, cap = args.n, args.communities, args.cap
  if args.graph == "social":
    w = torch.as_tensor(social_graph(n, seed=args.seed), device=dev)
  else:
    w = chung_lu_graph(n, args.edges, seed=args.seed, device=dev)
  obj = O.GraphCut(backend="auto")
  obj.init_w(w)  # symmetric, zero diagonal (in place)
  comm = torch.arange(n, device=dev) % n_comm     # community labels
  matroid = C.PartitionMatroid(num_parts=n_comm, caps=(cap,) * n_comm)
  out = alg3(w, comm, matroid, args.m, cap * n_comm, seed=args.seed,
             obj=obj)

  print(f"centralized RandomGreedy cut: {out['v_centralized']:.1f}")
  print(f"GreeDi (m={args.m}) cut:            {out['v_greedi']:.1f}  "
        f"(ratio {out['ratio']:.3f})")
  print(f"Thm 12 floor with tau=1/e, rho={matroid.rho()}: "
        f"{out['thm12_floor']:.3f}")
  counts = torch.bincount(comm[out["ids"]], minlength=n_comm)
  print(f"seeds per community: {counts.tolist()} (cap {cap})")
  assert bool((counts <= cap).all())
  return out


if __name__ == "__main__":
  main()
