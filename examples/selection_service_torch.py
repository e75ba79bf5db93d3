"""Streaming selection service -> trainer loop on the port (the
counterpart of examples/selection_service.py).

``train_with_selection_torch.py`` closes the paper's loop once: select a
coreset, train on it.  This example runs the loop the way a production
trainer consumes it: a long-lived ``SelectionService`` owns the m shards
(stacked on the one device), the corpus STREAMS in while training is
already underway, and every epoch re-randomizes the partition and
re-selects with warm-started lazy bounds -- the propose/select regime of
``launch/train.py`` (kappa proposals per shard, k_final selected), at
example scale:

  1. create the service; append the first half of the corpus;
  2. per epoch: ``service.epoch`` streams ``sel_gids`` + stats, the trainer
     consumes ``steps_per_epoch`` batches over that coreset
     (``data/pipeline.batches_from_epochs``), each fetch a heartbeat ack;
  3. after the first epoch the remaining documents arrive (``append``);
  4. a shard "dies" before the last epoch (its heartbeat stops); the
     protocol detects it, masks it out (``alive=1/2`` with two shards),
     and selection continues.

    PYTHONPATH=src python examples/selection_service_torch.py [--epochs 3]
    PYTHONPATH=src python examples/selection_service_torch.py --mesh 2 \
        --device cpu

``--mesh N`` runs N shards (the reference's forced host devices).
"""
import argparse
import time


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--epochs", type=int, default=3)
  ap.add_argument("--steps-per-epoch", type=int, default=30)
  ap.add_argument("--batch", type=int, default=8)
  ap.add_argument("--coreset", type=int, default=128)
  ap.add_argument("--mesh", type=int, default=0,
                  help="shards of the service (stacked on the device)")
  ap.add_argument("--device", default="cuda",
                  help="cuda (default) or cpu (the plain versions)")
  args = ap.parse_args(argv)

  import torch

  from repro_torch import no_tf32, resolve_device
  from repro_torch.configs import get_config, reduced
  from repro_torch.data.pipeline import EmbeddedCorpus, batches_from_epochs
  from repro_torch.models import build_model
  from repro_torch.service import SelectionService
  from repro_torch.train import OptConfig, init_opt_state, make_train_step

  no_tf32()
  dev = resolve_device(args.device)
  cfg = reduced(get_config("qwen3-4b"))
  seq_len = 64
  corpus = EmbeddedCorpus(n_docs=2048, feat_dim=64, vocab=cfg.vocab,
                          seq_len=seq_len, n_clusters=48, device=str(dev))
  feats = corpus.features()
  n_half = corpus.n_docs // 2

  # the propose/select regime of launch/train.py, at example scale: each
  # shard proposes kappa, the merge selects k_final
  svc = SelectionService(m=max(args.mesh, 1), d=64,
                         kappa=args.coreset // 2, k_final=args.coreset,
                         capacity=corpus.n_docs, deadline=30.0,
                         device=str(dev))
  svc.append(feats[:n_half])
  print(f"[service] ingested {n_half}/{corpus.n_docs} docs; "
        f"training starts while the rest embeds")

  model = build_model(cfg, device=dev, remat=None,
                      generator=torch.Generator(device=dev).manual_seed(42))
  opt = init_opt_state(model)
  total = args.epochs * args.steps_per_epoch
  step_fn = make_train_step(model, OptConfig(
      lr=1e-3, warmup_steps=max(total // 10, 5), total_steps=total))
  alive = []

  def selections():
    for e in range(args.epochs):
      if e == 1:
        svc.append(feats[n_half:])   # the rest of the corpus arrived
        print(f"[service] appended {corpus.n_docs - n_half} docs")
      if e == args.epochs - 1 and svc.board.m > 1:
        svc.board.fail(svc.board.m - 1)   # a shard dies mid-run
        print(f"[service] shard {svc.board.m - 1} stopped heartbeating")
      res = svc.epoch()
      s = res.stats
      alive.append(int(s.alive.sum()))
      print(f"[service] epoch {s.epoch}: {len(res.sel_gids)} docs from "
            f"{s.n_live} live, f={s.value:.4f}, "
            f"alive={int(s.alive.sum())}/{len(s.alive)}, "
            f"{s.wall_s:.2f}s, warm={s.warm}")
      yield res.sel_gids

  t0 = time.time()
  # the trainer's data-fetch cadence IS the liveness signal: every batch
  # fetched below beats the board, so healthy consumption keeps every shard
  # alive and the staged board.fail above is the only way a shard goes
  # dark.  One registration beat covers the model-build gap.
  svc.board.beat()
  losses = []
  for step, batch in enumerate(batches_from_epochs(
      corpus, selections(), args.batch, args.steps_per_epoch,
      board=svc.board)):
    metrics = step_fn(opt, batch)
    losses.append(float(metrics["loss"]))
    if step % 10 == 0 or step == total - 1:
      print(f"[train] step {step:4d} loss {losses[-1]:.4f} "
            f"({time.time()-t0:.0f}s)", flush=True)
  print(f"[done] {args.epochs} epochs, {len(losses)} steps, "
        f"{svc.n_docs} docs, alive per epoch {alive}")
  return losses, alive


if __name__ == "__main__":
  main()
