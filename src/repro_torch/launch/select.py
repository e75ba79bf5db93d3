"""GreeDi coreset selection from the command line (the port of the
one-shot modes of ``src/repro/launch/select.py``).

    PYTHONPATH=src python -m repro_torch.launch.select --mesh 16 --n 262144

With ``--mesh N`` the cached-similarity fast engine runs over N stacked
logical shards on the one card (``greedi_select_indices_sharded``); without
it the reference protocol runs over ``--m`` partitions.  Both return global
document indices, honor ``--out`` (npy, written before the coverage
baseline), and report coverage against the centralized greedy when n is
small enough for its O(k n^2) work to be cheap (force with ``--coverage``,
skip with ``--no-coverage``).  The run ends with one ``[select] done`` line.

``--device`` defaults to ``cuda`` and fails when CUDA is missing; ``cpu``
runs the kernels' plain versions.  The service, observability and
tree-merge flags of the reference CLI are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time


def _compact(v) -> str:
  if isinstance(v, bool):
    return str(v).lower()
  if isinstance(v, float):
    a = abs(v)
    if a != 0 and (a < 1e-3 or a >= 1e5):
      return f"{v:.3e}"
    return f"{v:.4f}".rstrip("0").rstrip(".")
  return str(v)


def stats_line(event: str, **fields) -> str:
  """``event key=value ...``, the reference CLI's stats-line format."""
  return " ".join([event] + [f"{k}={_compact(v)}" for k, v in fields.items()])


def main(argv=None) -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument("--n", type=int, default=65536)
  ap.add_argument("--d", type=int, default=64)
  ap.add_argument("--k", type=int, default=64)
  ap.add_argument("--kappa", type=int, default=None)
  ap.add_argument("--m", type=int, default=8,
                  help="logical partitions (reference path)")
  ap.add_argument("--mesh", type=int, default=0,
                  help="stacked logical shards for the fast engine")
  ap.add_argument("--kernel", default="linear", choices=["linear", "rbf"])
  ap.add_argument("--backend", default=None, choices=["cuda", "ref", "auto"],
                  help="gain-oracle backend override (kernels/dispatch.py)")
  ap.add_argument("--coverage", action="store_true",
                  help="force the centralized-greedy coverage baseline")
  ap.add_argument("--no-coverage", action="store_true",
                  help="skip the centralized-greedy coverage baseline")
  ap.add_argument("--out", default=None, help="write selected indices (npy)")
  ap.add_argument("--seed", type=int, default=0,
                  help="seed of the corpus and of the partition")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  args = ap.parse_args(argv)

  import numpy as np
  import torch

  from repro_torch import no_tf32, resolve_device
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (coverage_ratio,
                                          greedi_select_indices,
                                          greedi_select_indices_sharded)

  no_tf32()
  dev = resolve_device(args.device)
  kappa = args.kappa or args.k
  feats = EmbeddedCorpus(n_docs=args.n, feat_dim=args.d, seed=args.seed,
                         device=str(dev)).features()
  rng = torch.Generator().manual_seed(args.seed)

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  sync()
  t0 = time.perf_counter()
  if args.mesh:
    sel = greedi_select_indices_sharded(
        rng, feats, m=args.mesh, kappa=kappa, k_final=args.k,
        kernel=args.kernel, backend=args.backend)
    mode_fields = dict(mode="sharded", m=args.mesh, engine="fast",
                       merge="flat")
  else:
    sel = greedi_select_indices(rng, feats, m=args.m, kappa=kappa,
                                k_final=args.k, kernel=args.kernel,
                                backend=args.backend)
    mode_fields = dict(mode="reference", m=args.m)
  sync()
  t_sel = time.perf_counter() - t0

  # persist the coreset BEFORE the (expensive) coverage baseline
  if args.out:
    np.save(args.out, sel)
    print("[select] " + stats_line("wrote", path=args.out))
  done = dict(mode_fields, docs=len(sel), wall_s=t_sel,
              device=str(dev))
  want_cov = args.coverage or (not args.no_coverage and args.n <= 16384)
  if want_cov:
    done["coverage"] = coverage_ratio(feats, sel, args.k, kernel=args.kernel,
                                      backend=args.backend)
  elif not args.no_coverage:
    done["coverage"] = "skipped"
  print("[select] " + stats_line("done", **done))


if __name__ == "__main__":
  main()
