"""GreeDi coreset selection from the command line (the port of the
one-shot and service modes of ``src/repro/launch/select.py``).

    PYTHONPATH=src python -m repro_torch.launch.select --mesh 16 --n 262144
    PYTHONPATH=src python -m repro_torch.launch.select --mesh 16 --n 262144 \
        --epochs 3 --append-frac 0.25 --objective saturated_coverage

With ``--mesh N`` the cached-similarity fast engine (or, with
``--no-fast``, the generic objective engine) runs over N stacked logical
shards on the one card (``greedi_select_indices_sharded``); without it the
reference protocol runs over ``--m`` partitions.  With ``--mesh N --epochs
E`` the selection service runs instead (``service.SelectionService``):
the corpus less its last ``--append-frac`` is appended, E epochs run, and
the held-back rows are appended after the first; each epoch prints one
``[select] epoch`` line (with the round-1 lazy rescans per shard summed),
the append one ``[select] append`` line.  ``--objective
saturated_coverage`` selects over the absolute values of the features
(nonnegative coverage mass, as the reference does); ``--cold`` turns the
warm-started bounds off, ``--deadline`` sets the liveness deadline,
``--capacity`` the store's initial capacity (it doubles as appends need).  Every
mode returns global document indices, honors ``--out`` (npy, written
before the coverage baseline), and reports coverage against the
centralized greedy when n is small enough for its O(k n^2) work to be
cheap (force with ``--coverage``, skip with ``--no-coverage``).  The run
ends with one ``[select] done`` line.

Under torchrun the sharded and service modes run over the ranks of a
process group (``launch.mesh.ProcessMesh``): ``--mesh N`` shards in all,
N / P on each of the P ranks, every rank drawing the same corpus and
partition from the seed and selecting the same ids (in service mode every
rank appends the same rows, holds its shards of the store and answers the
queries from its replica of the sieves)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.select --mesh 16 --n-docs 262144
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.select --mesh 4 --dist-backend gloo \
        --device cpu --n-docs 4096 --dim 16 --k 8
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.select --mesh 4 --dist-backend gloo \
        --device cpu --n-docs 1000 --dim 16 --k 8 --epochs 2 \
        --append-frac 0.25

(``--n-docs`` and ``--dim`` are ``--n`` and ``--d``: the short spellings
are prefixes of torchrun's own options, which its parser takes for its own
under some Python 3.12 releases.)

``--dist-backend`` is ``nccl`` (one rank a card, the default on CUDA) or
``gloo`` (the default on the CPU; on CUDA every rank on the one card
``--device`` names).  Rank 0 prints the ``[select]`` lines and writes
``--out`` and ``--stats-json``; the ``done`` line adds ``world=``, every
rank's peak device memory (``rank_peak_gib``), rank 0's collectives
(``gathers=``, ``gather_bytes=``: all-gathers and the bytes it received;
``exchanges=``, ``exchange_bytes=``: the all-to-alls that move rows
between ranks and the bytes it received) and its kernel launches
(``launches=name:count,...``).  Every rank runs the ``--query-batch``
parity check.  With ``--metrics-port`` rank 0 serves the sidecar on its
own board: a ``POST /healthz`` beat for another rank's shard is refused
(409, naming the rank).  The reference path has no process backend and
refuses to run under torchrun; ``--dist-backend`` outside torchrun is
refused too.

``--merge-tree B`` merges the round-1 blocks through the accumulation tree
with B children a node (sharded and service modes; B = the shard count is
the flat merge, bit for bit); the ``done`` line then says ``merge=treeB``.

Service mode's query path: ``--query-every R`` appends the held-back rows
R at a time after the first epoch and runs ``query()`` after each block
(one ``[select] query`` line each: source, latency); ``--query-batch B``
answers B heterogeneous tenant requests (k, seed and exclusions varying)
through one ``query_batch`` call after the first append and again after
the last epoch, replays them one by one through ``query()``, and exits
non-zero unless every selection is the same (one ``[select] query_batch``
line each).  ``--device`` defaults to ``cuda`` and fails when CUDA is
missing; ``cpu`` runs the kernels' plain versions.

Observability (``repro_torch.obs``): every line is ``obs.stats_line``;
``--trace-out PATH`` enables obs and writes the spans as JSONL,
``--stats-json PATH`` enables obs and writes every stats line as a record
with a registry snapshot, ``--metrics-port P`` serves the sidecar
(``/metrics``, ``/healthz``; 0 picks a free port, bound to 127.0.0.1; in
service mode ``POST /healthz`` beats the service's heartbeat board) and
prints one ``[select] sidecar`` line with its URL, and ``--linger S`` keeps
the sidecar up S seconds after the run.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import obs


def _query_batch_cycle(svc, b: int, k: int, stage: str, sync, emit) -> None:
  """Answer ``b`` heterogeneous tenant requests through one
  ``query_batch`` call, replay them one by one through ``query()``, and
  exit non-zero unless every selection is the same (value estimates to
  1e-5 relative)."""
  import numpy as np

  from repro_torch.service import QueryRequest
  mc = svc.store.query_mask_cap
  base = svc.query()  # live gids for the exclusion lists
  reqs = [QueryRequest(k=1 + (i % k), seed=i % 4, exclude_gids=tuple(
      int(g) for g in base.sel_gids[:min(i % 3, mc)])) for i in range(b)]
  sync()
  t0 = time.perf_counter()
  batched = svc.query_batch(reqs)
  t_batch = time.perf_counter() - t0
  t0 = time.perf_counter()
  seq = [svc.query(r.k, seed=r.seed, exclude_gids=r.exclude_gids)
         for r in reqs]
  t_seq = time.perf_counter() - t0
  for i, (rb, rs) in enumerate(zip(batched, seq)):
    if (not np.array_equal(rb.sel_gids, rs.sel_gids) or not np.isclose(
        rb.value_estimate, rs.value_estimate, rtol=1e-5, atol=1e-7)):
      raise SystemExit(f"[select] query_batch parity FAILED ({stage}, "
                       f"request {i}): batched={rb.sel_gids} "
                       f"(v={rb.value_estimate!r}) sequential="
                       f"{rs.sel_gids} (v={rs.value_estimate!r})")
  emit("query_batch", stage=stage, requests=b, batch_ms=t_batch * 1e3,
       qps=b / max(t_batch, 1e-9), seq_ms=t_seq * 1e3,
       speedup=t_seq / max(t_batch, 1e-9), parity="ok",
       batch_calls=svc.store.query_batch_calls)


def _rank_stats(mesh, dev, sel) -> dict:
  """Every rank's peak device memory (GiB, comma-separated in rank order;
  "not measured" on the CPU), this rank's collectives and kernel launches,
  for the ``done`` line.  Raises unless every rank selected the same
  ids."""
  import torch
  import torch.distributed as dist

  from repro_torch.kernels import ops
  peak = (torch.cuda.max_memory_allocated(dev) / 2**30
          if dev.type == "cuda" else None)
  got = [None] * mesh.world
  dist.all_gather_object(got, (peak, sel.tolist()), group=mesh.group)
  if any(ids != got[0][1] for _, ids in got):
    raise RuntimeError(f"[select] the ranks selected different ids: "
                       f"{[ids for _, ids in got]}")
  launches = ",".join(f"{k}:{v}" for k, v in ops.launch_counts().items()
                      if v)
  return dict(rank_peak_gib=(",".join(f"{p:.6f}" for p, _ in got)
                             if peak is not None else "not measured"),
              gathers=mesh.gathers, gather_bytes=mesh.gather_bytes,
              exchanges=mesh.exchanges, exchange_bytes=mesh.exchange_bytes,
              launches=launches or "none")


def _service(args, feats, kappa, dev, sync, emit, serve, mesh=None):
  """The service mode: append, run the epochs, append the held-back rows
  after the first; returns (last epoch's ids, the features selected
  over).  ``serve(board)`` starts the sidecar on the service's board;
  ``mesh`` runs the shards over the ranks."""
  from repro_torch.service import SelectionService
  svc = SelectionService(m=args.mesh, d=args.d, kappa=kappa, k_final=args.k,
                         capacity=args.capacity or args.n, kernel=args.kernel,
                         backend=args.backend, warm_start=not args.cold,
                         deadline=args.deadline, objective=args.objective,
                         merge="tree" if args.merge_tree else "flat",
                         tree_branch=args.merge_tree or None, device=dev,
                         mesh=mesh)
  # POST /healthz beats feed the same board as the in-process beats
  serve(svc.board)
  if args.objective == "saturated_coverage":
    feats = feats.abs()  # nonnegative coverage mass (Lin & Bilmes)
  n0 = args.n - int(args.n * args.append_frac)
  svc.append(feats[:n0])
  if args.query_batch:
    _query_batch_cycle(svc, args.query_batch, args.k, "pre-epoch", sync,
                       emit)
  res = None
  for e in range(args.epochs):
    svc.board.beat()  # every shard of this process is alive by construction
    res = svc.epoch()
    s = res.stats
    emit("epoch", epoch=s.epoch, docs=len(res.sel_gids), live=s.n_live,
         cap=s.capacity, f=s.value, alive=int(s.alive.sum()),
         shards=len(s.alive), warm=s.warm, wall_s=s.wall_s,
         rescans=int(s.rescans.sum()))
    if e == 0 and n0 < args.n:
      sync()
      t0 = time.perf_counter()
      if args.query_every:
        # the held-back rows in blocks, "which k now?" after each from the
        # standing sieves, no epoch run
        for off in range(n0, args.n, args.query_every):
          svc.append(feats[off:off + args.query_every])
          q = svc.query()
          emit("query", docs=svc.n_docs, ids=len(q.sel_gids),
               source=q.source, est=q.value_estimate,
               stale_appends=q.appends_since_epoch, wall_ms=q.wall_s * 1e3)
      else:
        svc.append(feats[n0:])
      sync()
      wall = time.perf_counter() - t0
      emit("append", docs=args.n - n0, wall_s=wall,
           rows_per_s=(args.n - n0) / max(wall, 1e-9), growths=svc.growths)
  if args.query_batch:
    _query_batch_cycle(svc, args.query_batch, args.k, "post-epoch", sync,
                       emit)
  return res.sel_gids, feats


def main(argv=None) -> None:
  ap = argparse.ArgumentParser()
  # --n-docs / --dim: the spellings torchrun's own parser leaves alone
  ap.add_argument("--n", "--n-docs", dest="n", type=int, default=65536)
  ap.add_argument("--d", "--dim", dest="d", type=int, default=64)
  ap.add_argument("--k", type=int, default=64)
  ap.add_argument("--kappa", type=int, default=None)
  ap.add_argument("--m", type=int, default=8,
                  help="logical partitions (reference path)")
  ap.add_argument("--mesh", type=int, default=0,
                  help="stacked logical shards for the sharded path")
  ap.add_argument("--no-fast", action="store_true",
                  help="sharded path: use the generic objective engine "
                  "instead of the cached-similarity fast engine")
  ap.add_argument("--merge-tree", type=int, default=0, metavar="B",
                  help="merge the round-1 blocks through an accumulation "
                  "tree with B children a node instead of all at once "
                  "(sharded and service modes; 0 = flat; B = the shard "
                  "count is bit-identical to flat)")
  ap.add_argument("--epochs", type=int, default=0,
                  help="run the multi-epoch SelectionService for this many "
                  "epochs (mesh mode only)")
  ap.add_argument("--objective", default="facility",
                  choices=["facility", "saturated_coverage", "info_gain"],
                  help="service mode: selection objective; warm starts "
                  "engage for any objective with a registered bound "
                  "maintainer (core/objectives.py)")
  ap.add_argument("--append-frac", type=float, default=0.0,
                  help="service mode: fraction of the corpus appended only "
                  "after the first epoch (streaming ingest)")
  ap.add_argument("--capacity", type=int, default=0, metavar="C",
                  help="service mode: the store's initial capacity (default "
                  "--n); it doubles as the appends need")
  ap.add_argument("--query-every", type=int, default=0, metavar="R",
                  help="service mode: append the held-back rows R at a "
                  "time and run query() after each block")
  ap.add_argument("--query-batch", type=int, default=0, metavar="B",
                  help="service mode: answer B heterogeneous requests "
                  "through one query_batch call after the first append "
                  "and after the last epoch, and fail unless they select "
                  "what sequential query() calls select")
  ap.add_argument("--cold", action="store_true",
                  help="service mode: disable warm-started lazy bounds")
  ap.add_argument("--deadline", type=float, default=None,
                  help="service mode: straggler liveness deadline (seconds)")
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
  ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                  help="under torchrun: the process group's backend "
                  "(default nccl on CUDA, gloo on the CPU)")
  ap.add_argument("--metrics-port", type=int, default=None,
                  help="serve the obs sidecar (/metrics Prometheus text, "
                  "/healthz liveness) on 127.0.0.1 at this port (0 = pick "
                  "a free one); service mode wires POST /healthz beats "
                  "into the heartbeat board")
  ap.add_argument("--trace-out", default=None,
                  help="write obs trace spans as JSONL to this path")
  ap.add_argument("--stats-json", default=None,
                  help="write every stats line plus a metrics-registry "
                  "snapshot to this path as JSON (all modes)")
  ap.add_argument("--linger", type=float, default=0.0,
                  help="keep the sidecar serving this many seconds after "
                  "the run (a scrape window)")
  args = ap.parse_args(argv)

  import numpy as np
  import torch

  from repro_torch import no_tf32, resolve_device
  from repro_torch.data.pipeline import EmbeddedCorpus
  from repro_torch.data.selection import (coverage_ratio,
                                          greedi_select_indices,
                                          greedi_select_indices_sharded)
  from repro_torch.launch.mesh import ProcessMesh, under_torchrun

  no_tf32()
  mesh = None
  if under_torchrun():
    if not args.mesh:
      raise SystemExit("[select] under torchrun the sharded and service "
                       "modes run over the ranks: pass --mesh N (N a "
                       "multiple of the ranks); the reference path has no "
                       "process backend")
    backend = args.dist_backend or (
        "nccl" if torch.device(args.device).type == "cuda" else "gloo")
    mesh = ProcessMesh.from_env(args.mesh, backend, args.device)
    dev = mesh.device
  elif args.dist_backend:
    raise SystemExit("[select] --dist-backend needs the ranks of a "
                     "torchrun launch (python -m torch.distributed.run)")
  else:
    dev = resolve_device(args.device)
  lead = mesh is None or mesh.rank == 0
  kappa = args.kappa or args.k
  feats = EmbeddedCorpus(n_docs=args.n, feat_dim=args.d, seed=args.seed,
                         device=str(dev)).features()
  rng = torch.Generator().manual_seed(args.seed)

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  obs_on = lead and (args.trace_out or args.stats_json or
                     args.metrics_port is not None)
  if obs_on:
    obs.enable(trace_out=args.trace_out)
  records: list = []

  def emit(event, **fields):
    """The one stats format of every mode: a stats line on stdout and a
    record for --stats-json."""
    if lead:
      print("[select] " + obs.stats_line(event, **fields), flush=True)
    records.append(dict(event=event, **fields))

  sidecar = None

  def serve(board=None):
    nonlocal sidecar
    if args.metrics_port is not None and lead:
      sidecar = obs.Sidecar(board=board, port=args.metrics_port)
      emit("sidecar", url=sidecar.url)

  merge = f"tree{args.merge_tree}" if args.merge_tree else "flat"
  sync()
  t0 = time.perf_counter()
  if args.mesh and args.epochs:
    sel, feats = _service(args, feats, kappa, dev, sync, emit, serve, mesh)
    mode_fields = dict(mode="service", m=args.mesh, epochs=args.epochs,
                       objective=args.objective, merge=merge)
  elif args.mesh:
    serve()
    sel = greedi_select_indices_sharded(
        rng, feats, m=args.mesh, kappa=kappa, k_final=args.k,
        kernel=args.kernel, backend=args.backend, fast=not args.no_fast,
        merge="tree" if args.merge_tree else "flat",
        tree_branch=args.merge_tree or None, mesh=mesh)
    mode_fields = dict(mode="sharded", m=args.mesh,
                       engine="generic" if args.no_fast else "fast",
                       merge=merge)
  else:
    serve()
    sel = greedi_select_indices(rng, feats, m=args.m, kappa=kappa,
                                k_final=args.k, kernel=args.kernel,
                                backend=args.backend)
    mode_fields = dict(mode="reference", m=args.m)
  sync()
  t_sel = time.perf_counter() - t0
  if mesh is not None:
    mode_fields.update(world=mesh.world, backend=mesh.backend,
                       **_rank_stats(mesh, dev, sel))

  if not lead:
    mesh.close()
    return
  # persist the coreset BEFORE the (expensive) coverage baseline
  if args.out:
    np.save(args.out, sel)
    emit("wrote", path=args.out)
  done = dict(mode_fields, docs=len(sel), wall_s=t_sel,
              device=str(dev))
  want_cov = args.coverage or (not args.no_coverage and args.n <= 16384)
  if want_cov:
    done["coverage"] = coverage_ratio(feats, sel, args.k, kernel=args.kernel,
                                      backend=args.backend)
  elif not args.no_coverage:
    done["coverage"] = "skipped"
  emit("done", **done)
  if args.stats_json:
    obs.write_stats_json(args.stats_json, records,
                         tool="repro_torch.launch.select", n=args.n,
                         d=args.d, k=args.k, mesh=args.mesh,
                         epochs=args.epochs, device=str(dev))
    print(f"[select] wrote {args.stats_json}", flush=True)
  if sidecar is not None:
    if args.linger > 0:
      time.sleep(args.linger)
    sidecar.close()
  if obs_on:
    obs.disable()  # closes the trace; an in-process caller gets obs back off
  if mesh is not None:
    mesh.close()


if __name__ == "__main__":
  main()
